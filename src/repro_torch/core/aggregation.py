"""Weighted model aggregation (the federator's merge), the port's copy of
the JAX package's ``core/aggregation.py``.

* ``weighted_average``: the host view, a stack of P clients' parameters
  and a (P,) weight vector; the oracle the fused merge
  (:mod:`repro_torch.fed.merge`) is tested against.
* ``psum_weighted`` / ``broadcast_from``: the collective view, one rank
  per client in a ``torch.distributed`` process group (the reference's
  mesh axis); each rank holds its own parameters and the merge is one
  collective over the group (NCCL on the card, gloo on the CPU).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def weighted_average(stacked: Sequence[torch.Tensor],
                     weights: torch.Tensor) -> list[torch.Tensor]:
    """``stacked[k]`` holds parameter k of every client on a leading client
    axis P; returns each parameter's ``weights``-weighted average over it,
    the weights normalized as ``w / max(sum(w), 1e-12)``."""
    w = torch.as_tensor(weights).float()
    w = w / torch.clamp(torch.sum(w), min=1e-12)
    return [torch.sum(leaf * w.reshape((-1,) + (1,) * (leaf.dim() - 1)),
                      dim=0) for leaf in stacked]


def _collective(local, reduce) -> list[torch.Tensor] | torch.Tensor:
    """``local`` (a tensor or a sequence of them) flattened into one
    float32 buffer, ``reduce(buf)`` run on it in place, and the result
    written back into ``local``'s tensors; returns ``local``."""
    leaves = [local] if isinstance(local, torch.Tensor) else list(local)
    with torch.no_grad():
        buf = torch.cat([t.detach().reshape(-1).float() for t in leaves])
        reduce(buf)
        off = 0
        for t in leaves:
            t.copy_(buf[off:off + t.numel()].view(t.shape))
            off += t.numel()
    return local


def psum_weighted(local, local_weight: torch.Tensor | float,
                  group: dist.ProcessGroup | None = None):
    """Collective weighted merge: this rank contributes ``local_weight *
    local`` and every rank receives the sum over ``group`` (default: the
    world), written back into ``local``'s tensors in place and returned.
    The weights must already sum to 1 over the group (softmax output).
    One flat buffer, one ``all_reduce(SUM)``: one collective per merge,
    as the reference's one ``psum``."""
    def reduce(buf):
        buf.mul_(torch.as_tensor(local_weight, dtype=buf.dtype,
                                 device=buf.device))
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return _collective(local, reduce)


def broadcast_from(local, src: int = 0,
                   group: dist.ProcessGroup | None = None):
    """Rank ``src``'s tensors (its rank within ``group``) on every rank,
    written into ``local`` in place and returned: the reference's masked
    psum, as one ``broadcast``."""
    def reduce(buf):
        dist.broadcast(buf, src=src if group is None
                       else dist.get_global_rank(group, src), group=group)
    return _collective(local, reduce)
