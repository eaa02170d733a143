from .optimizers import (AdamState, Optimizer, Schedule, adam,
                         clip_by_global_norm, constant_schedule,
                         cosine_schedule)

__all__ = ["AdamState", "Optimizer", "Schedule", "adam",
           "clip_by_global_norm", "constant_schedule", "cosine_schedule"]
