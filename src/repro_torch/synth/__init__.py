from .engine import (RoundEngine, sample_synthetic_conditional,
                     synthesize_table)
from .sampler import (DeviceSampler, SamplerDraws, SamplerTables, draw_batch,
                      draw_conditions, stack_sampler_tables)
