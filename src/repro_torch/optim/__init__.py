from .optimizers import (AdamState, Optimizer, Schedule, SGDState, adam,
                         clip_by_global_norm, constant_schedule,
                         cosine_schedule, sgd)

__all__ = ["AdamState", "Optimizer", "Schedule", "SGDState", "adam",
           "clip_by_global_norm", "constant_schedule", "cosine_schedule",
           "sgd"]
