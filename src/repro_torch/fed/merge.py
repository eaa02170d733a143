"""The whole-model federator merge in ONE ``weighted_agg`` dispatch, the
port's copy of the JAX package's ``fed/merge.py``.

Every client's parameters (generator and critic together) are written
into row p of one ``(P, D)`` float32 buffer, merged by one launch of the
``weighted_agg`` kernel (:func:`repro_torch.kernels.ops.
weighted_average_flat`), and copied back into every client's modules.  A
client's parameters are a list of tensors in a fixed order
(:meth:`repro_torch.gan.trainer.GANState.params`); optimizer moments are
not merged.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..kernels import ops


class MergeLayoutError(ValueError):
    """The flat merge buffer and the clients' parameters disagree on
    layout (a client's shapes, or the total element count).  Raised
    instead of silently misaligning parameters: a misaligned unflatten
    gives valid floats in the wrong places, with no numerical signal."""


def flatten_stacked(trees: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
    """``trees[p]`` is client p's parameter list; returns the ``(P, D)``
    float32 buffer whose row p is client p's parameters, flattened in list
    order.  Every client must have the same shapes in the same order."""
    shapes = [tuple(t.shape) for t in trees[0]]
    bad = [p for p, tree in enumerate(trees)
           if [tuple(t.shape) for t in tree] != shapes]
    if bad:
        raise MergeLayoutError(f"clients {bad} have other parameter shapes "
                               f"than client 0 ({shapes})")
    D = sum(t.numel() for t in trees[0])
    flat = torch.empty((len(trees), D), dtype=torch.float32,
                       device=trees[0][0].device)
    with torch.no_grad():
        for p, tree in enumerate(trees):
            torch.cat([t.detach().reshape(-1).float() for t in tree],
                      out=flat[p])
    return flat


def unflatten_merged(flat: torch.Tensor,
                     like: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Inverse of :func:`flatten_stacked` for one merged ``(D,)`` vector:
    views of it shaped as the tensors of ``like``.  Its length must be
    exactly ``like``'s element count, else :class:`MergeLayoutError`."""
    total = sum(t.numel() for t in like)
    if flat.dim() != 1 or flat.shape[0] != total:
        raise MergeLayoutError(
            f"flat merge buffer has shape {tuple(flat.shape)} but the "
            f"parameter layout needs ({total},)")
    out, off = [], 0
    for t in like:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


def fused_weighted_merge(trees: Sequence[Sequence[torch.Tensor]],
                         weights: torch.Tensor) -> list[torch.Tensor]:
    """Merge the clients' parameters in ONE ``weighted_agg`` dispatch;
    ``weights`` (P,) is normalized inside.  Returns the merged parameters
    (shaped as client 0's)."""
    merged = ops.weighted_average_flat(flatten_stacked(trees), weights)
    return unflatten_merged(merged, trees[0])


def tiered_weighted_merge_flat(flat: torch.Tensor, weights: torch.Tensor,
                               n_edges: int) -> torch.Tensor:
    """Hierarchical merge: clients -> ``n_edges`` edge aggregators ->
    federator, ONE ``weighted_agg`` dispatch per tier.

    The ``(P, D)`` stack is cut into ``n_edges`` contiguous groups of C
    clients; every edge merges in one launch (``weighted_average_edges``),
    then the federator merges the edges under the tier weights ``W_e``,
    the sum of each edge's client weights.  Since ``sum_e (W_e / W) *
    sum_{p in e} (w_p / W_e) x_p = sum_p (w_p / W) x_p``, this equals the
    flat merge up to rounding.  An edge of all-zero weights merges to
    zeros and carries tier weight 0."""
    P = flat.shape[0]
    if n_edges < 1 or P % n_edges:
        raise ValueError(f"n_edges={n_edges} must be >= 1 and divide the "
                         f"client count P={P}")
    C = P // n_edges
    w = weights.reshape(n_edges, C)
    edge_merged = ops.weighted_average_edges(flat.reshape(n_edges, C, -1), w)
    tier_w = torch.sum(w, dim=1)
    edge_safe = torch.where((tier_w > 0)[:, None], edge_merged, 0.0)
    return ops.weighted_average_flat(edge_safe, tier_w)


def tiered_weighted_merge(trees: Sequence[Sequence[torch.Tensor]],
                          weights: torch.Tensor,
                          n_edges: int) -> list[torch.Tensor]:
    """:func:`fused_weighted_merge` through the two tiers of
    :func:`tiered_weighted_merge_flat` (two ``weighted_agg`` dispatches)."""
    merged = tiered_weighted_merge_flat(flatten_stacked(trees), weights,
                                        n_edges)
    return unflatten_merged(merged, trees[0])


@torch.no_grad()
def replicate(merged: Sequence[torch.Tensor],
              trees: Sequence[Sequence[torch.Tensor]]) -> None:
    """The federator's redistribution: copy the merged parameters into
    every client's tensors, in place (each client keeps its own storage)."""
    for tree in trees:
        for t, m in zip(tree, merged, strict=True):
            t.copy_(m)
