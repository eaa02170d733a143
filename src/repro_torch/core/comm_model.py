"""Bytes on the wire of the federated architecture (§3, §5.4), the part of
the JAX package's ``core/comm_model.py`` that ``run_federated`` reports.

Float32 payloads, counted at the federator's link: every client uploads
its model and the federator sends the merged model back."""
from __future__ import annotations

from typing import Iterable

import torch


def param_bytes(params: Iterable[torch.Tensor]) -> float:
    """Bytes of a model's parameters."""
    return float(sum(p.numel() * p.element_size() for p in params))


def fl_bytes_per_round(n_clients: int, model_bytes: float) -> float:
    """FL: 2 * P * |theta| per round (up and back down)."""
    return 2.0 * n_clients * model_bytes
