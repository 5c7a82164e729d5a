from repro_torch.optim import schedule
from repro_torch.optim.optim import (LR, AdagradState, AdamState, Optimizer,
                                    SGDState, adagrad, adam, apply_updates,
                                    clip_by_global_norm, global_norm, sgd,
                                    yogi)

__all__ = ["LR", "AdagradState", "AdamState", "Optimizer", "SGDState",
           "adagrad", "adam", "apply_updates", "clip_by_global_norm",
           "global_norm", "schedule", "sgd", "yogi"]
