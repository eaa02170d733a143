from .ctgan import (CTGANConfig, Generator, apply_activations,
                    apply_activations_fused, init_generator)
from .trainer import sample_synthetic
