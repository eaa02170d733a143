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
from .setup import Federation, setup_federation, tile_federation
from .sharded import shard_map_global_round, shard_map_weighted_round

_SCENARIO_EXPORTS = ("SCENARIOS", "Scenario", "partition", "run_matrix",
                     "FAULTS", "build_fault_plan")


def __getattr__(name):
    # scenarios is loaded lazily, so that `python -m
    # repro_torch.fed.scenarios` does not import it twice (the package
    # import and runpy) and warn
    if name in _SCENARIO_EXPORTS:
        from . import scenarios
        return getattr(scenarios, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
