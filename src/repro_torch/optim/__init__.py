from .optimizers import AdamState, Optimizer, adam
