from .faults import (DEFAULT_NORM_MULT, FaultPlan, NoSurvivingClients,
                     PoisonedRunError, UpdateGuard, apply_faults,
                     apply_faults_tree, byzantine_scale, compose,
                     corrupt_nans, dropout_uniform, guard_ok, no_faults,
                     sanitize_stacked, straggler_deadline,
                     update_diagnostics)
from .merge import (MergeLayoutError, flatten_stacked, fused_weighted_merge,
                    replicate, tiered_weighted_merge,
                    tiered_weighted_merge_flat, unflatten_merged)
from .program import WEIGHTINGS, FederatedProgram, resolve_weights
from .setup import Federation, setup_federation
