from repro_torch.optim.optim import (LR, AdamState, Optimizer, SGDState,
                                    adam, apply_updates, sgd)

__all__ = ["LR", "AdamState", "Optimizer", "SGDState", "adam",
           "apply_updates", "sgd"]
