from repro_torch.optim.optim import (LR, AdagradState, AdamState, Optimizer,
                                    SGDState, adagrad, adam, apply_updates,
                                    sgd, yogi)

__all__ = ["LR", "AdagradState", "AdamState", "Optimizer", "SGDState",
           "adagrad", "adam", "apply_updates", "sgd", "yogi"]
