from .merge import (MergeLayoutError, flatten_stacked, fused_weighted_merge,
                    replicate, tiered_weighted_merge,
                    tiered_weighted_merge_flat, unflatten_merged)
from .program import WEIGHTINGS, FederatedProgram, resolve_weights
from .setup import Federation, setup_federation
