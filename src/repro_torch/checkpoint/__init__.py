from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .fed_checkpoint import (TORCH_RNG_KEY, restore_fed_checkpoint,
                             save_fed_checkpoint)
