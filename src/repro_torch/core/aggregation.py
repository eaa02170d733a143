"""The per-parameter weighted average: the oracle the fused federator merge
(:mod:`repro_torch.fed.merge`) is tested against, the port's copy of the
JAX package's ``core/aggregation.py:weighted_average``."""
from __future__ import annotations

from typing import Sequence

import torch


def weighted_average(stacked: Sequence[torch.Tensor],
                     weights: torch.Tensor) -> list[torch.Tensor]:
    """``stacked[k]`` holds parameter k of every client on a leading client
    axis P; returns each parameter's ``weights``-weighted average over it,
    the weights normalized as ``w / max(sum(w), 1e-12)``."""
    w = torch.as_tensor(weights).float()
    w = w / torch.clamp(torch.sum(w), min=1e-12)
    return [torch.sum(leaf * w.reshape((-1,) + (1,) * (leaf.dim() - 1)),
                      dim=0) for leaf in stacked]
