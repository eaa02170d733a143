"""The privacy attack harness on the port, the copy of the JAX package's
``privacy/``:

* :mod:`repro_torch.privacy.trace`: :class:`RoundTrace` records what
  Fed-TGAN transmits (the §4.1 setup statistics and every round's flat
  ``(P, D)`` update stack and §4.2 weights) to a replayable ``.npz`` that
  either package reads, through ``run_federated(trace=...)`` on the fused
  program and the host oracle;
* :mod:`repro_torch.privacy.attacks`: membership inference
  (loss-threshold and shadow-calibrated) and update-leakage column
  reconstruction, replayed from traces;
* the in-program defense is :mod:`repro_torch.gan.dp`, threaded through
  ``RoundEngine(dp=...)``, ``FederatedProgram(dp=...)`` and
  ``run_federated(dp=...)``.
"""
from .attacks import (AttackError, attack_auc, category_probe_scores,
                      category_update_energy, client_params,
                      discriminator_scores, dominant_category_hits,
                      global_params, leakage_report, loss_threshold_mia,
                      null_auc, setup_marginals, shadow_model_mia,
                      vgm_client_moments)
from .trace import RoundTrace, TraceError

__all__ = [
    "AttackError",
    "RoundTrace",
    "TraceError",
    "attack_auc",
    "category_probe_scores",
    "category_update_energy",
    "client_params",
    "discriminator_scores",
    "dominant_category_hits",
    "global_params",
    "leakage_report",
    "loss_threshold_mia",
    "null_auc",
    "setup_marginals",
    "shadow_model_mia",
    "vgm_client_moments",
]
