"""Bytes on the wire of the decentralized architectures (§3, §5.4), the
port's copy of the JAX package's ``core/comm_model.py``.

Float32 payloads, counted at the server's or federator's link, which is
the bottleneck of both architectures (1 GbE in the paper's testbed,
measured at 943 Mb/s).  ``transfer_seconds`` turns bytes into seconds on
that link; ``fl_round_seconds`` and ``md_epoch_seconds`` are the wall
models of one FL round and one MD epoch."""
from __future__ import annotations

from typing import Iterable

import torch

FP = 4  # bytes per float32 on the wire
LINK_BITS_PER_S = 943e6


def param_bytes(params: Iterable[torch.Tensor]) -> float:
    """Bytes of a model's parameters."""
    return float(sum(p.numel() * p.element_size() for p in params))


def fl_bytes_per_round(n_clients: int, model_bytes: float) -> float:
    """FL: 2 * P * |theta| per round (up and back down)."""
    return 2.0 * n_clients * model_bytes


def md_bytes_per_epoch(n_clients: int, steps: int, batch: int,
                       row_bytes_dim: int, disc_bytes: float,
                       swap: bool = True) -> float:
    """MD per training epoch at the server's link: a synthetic batch to
    every critic twice per step (the critic update and the generator
    pass) and the feedback gradients w.r.t. it back from every client;
    plus the discriminator swap (server-coordinated in the prototype)."""
    batch_bytes = batch * row_bytes_dim * FP
    per_step = n_clients * (2 * batch_bytes + batch_bytes)
    total = steps * per_step
    if swap:
        total += n_clients * disc_bytes
    return float(total)


def transfer_seconds(nbytes: float) -> float:
    """Seconds to move ``nbytes`` over the paper's 943 Mb/s link."""
    return nbytes * 8.0 / LINK_BITS_PER_S


def fl_round_seconds(n_clients: int, model_bytes: float, local_step_s: float,
                     local_steps: int, agg_s: float = 1e-3) -> float:
    """One FL round: local training in parallel, the transfers serialized
    at the federator's link, and the merge."""
    return local_steps * local_step_s + transfer_seconds(
        fl_bytes_per_round(n_clients, model_bytes)) + agg_s


def md_epoch_seconds(n_clients: int, steps: int, batch: int, row_dim: int,
                     disc_bytes: float, d_step_s: float,
                     g_step_s: float) -> float:
    """One MD epoch: the steps' critic and generator updates plus the
    epoch's transfers at the server's link."""
    return (steps * (d_step_s + g_step_s)
            + transfer_seconds(md_bytes_per_epoch(n_clients, steps, batch,
                                                  row_dim, disc_bytes)))
