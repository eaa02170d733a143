from .ctgan import (CTGANConfig, Discriminator, Generator, apply_activations,
                    apply_activations_fused, conditional_loss,
                    gradient_penalty, init_discriminator, init_generator)
from .sampler import ConditionalSampler
from .trainer import (GANState, StepNoise, draw_step_noise, init_gan_state,
                      local_train_scan, make_round_batches,
                      make_train_steps, sample_synthetic, stack_metrics)
