"""Sharding policy: parameter, batch and cache specs for any arch x mesh,
the port's copy of the JAX package's ``launch/shardings.py``, and their
distribution as DTensors.

Policy (the reference's):
  * ``tp`` ("model" axis): tensor-parallel dim of every big weight
    (H*hd / d_ff / vocab / d_inner / expert axis).
  * ``fsdp`` (the data axes): the other big dim of each weight is sharded
    over data+pod (ZeRO-3 style) so >=100B configs fit; ``fsdp=False``
    replicates weights over data instead.
  * Experts: E >= tp-size -> expert-parallel (E over model) and d_ff over
    fsdp; else per-expert d_ff over model, d_model over fsdp.  ``f2d``
    shards d_ff over (data x model); ``ep_pad`` shards E over the data
    axes unevenly (DTensor's uneven ``Shard``: rank 0 holds ceil(E / dp)
    experts, as GSPMD's padded shard does).
  * Any annotated dim that does not divide its axis size falls back to
    replication on that dim (e.g. hubert's vocab=504).

Specs are :class:`repro_torch.models.PartitionSpec` values equal to the
reference's, entry for entry, with the reference's leading ``n_rep``
entry dropped from layer leaves (the port keeps one tree per repetition)
and, for caches, from every leaf.  A policy reads only the mesh's axis
names (``mesh_dim_names``) and sizes (``shape``), so specs can be built
without a process group; :func:`placements` and :func:`distribute` need a
real :class:`~torch.distributed.device_mesh.DeviceMesh`.
:class:`ReshardFallbacks` does what GSPMD does implicitly where DTensor
refuses an op on sharded inputs, and nothing where the op itself fails.
"""
from __future__ import annotations

import dataclasses
import os
import re
import traceback
from collections import Counter
from typing import Any

import torch
from torch._decomp import decomposition_table
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map_only

from .. import counting
from ..models.layers import PartitionSpec as P
from ..models.layers import spec_placements
from ..models.model import tree_items, tree_unflatten

PyTree = Any


@dataclasses.dataclass
class ShardPolicy:
    mesh: Any
    fsdp: bool = True
    # MoE expert-weight layout:
    #   auto: E>=tp -> experts over model + d_ff over data;
    #         else  -> d_model over data + d_ff over model
    #   f2d:  d_ff over (data x model) combined: contraction dims unsharded
    #   ep_pad: E over data (padded), d_ff over model
    moe_mode: str = "auto"

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))

    @property
    def dp(self) -> tuple[str, ...]:
        return tuple(a for a in self.mesh.mesh_dim_names
                     if a in ("pod", "data"))

    @property
    def tp(self) -> str:
        return "model"

    @property
    def fsdp_axes(self):
        return self.dp if self.fsdp else None

    def axis_size(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        n = 1
        for a in axes:
            n *= self.sizes[a]
        return n


# rule table: (path regex, spec template aligned to TRAILING dims).
# 'T' = tensor axis, 'F' = fsdp axes, None = replicated.
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed$",                ("T", "F")),
    (r"lm_head$",              ("F", "T")),
    (r"in_proj$",              (None, "T")),
    (r"experts/(w_gate|w_up)$",  ("EXP",)),
    (r"experts/w_down$",         ("EXPD",)),
    (r"router$",               (None, None)),
    (r"(wq|wk|wv)$",           ("F", "T")),
    (r"(wq|wk|wv)_bias$",      ("T",)),
    (r"wo$",                   ("T", "F")),
    (r"(w_gate|w_up)$",        ("F", "T")),
    (r"w_down$",               ("T", "F")),
    (r"(ssm_in|ssm_gate)$",    ("F", "T")),
    (r"ssm_out$",              ("T", "F")),
    (r"(ssm_dt|ssm_bc|ssm_a|ssm_conv)$", ("T", None)),
    (r"(ssm_d|ssm_dt_bias)$",  ("T",)),
    (r"(gate_i|gate_f|gate_o)$", ("F", None)),
    (r"slstm_wx$",             ("F", "T")),
    # slstm_r is tiny (H x hd x 4hd) and lives inside the per-step loop:
    # sharding it all-reduces its gradient every timestep; replicate it
    (r"slstm_r$",              (None, None, None)),
]


def _resolve(template, pol: ShardPolicy, shape, expert_parallel: bool) -> P:
    if template == ("EXP",):       # (E, D, F)
        if pol.moe_mode == "f2d":
            template = (None, None, "FT")
        elif pol.moe_mode == "ep_pad":
            template = ("F!", None, "T")    # E over data, padded
        else:
            template = (("T", None, "F") if expert_parallel
                        else (None, "F", "T"))
    elif template == ("EXPD",):    # (E, F, D)
        if pol.moe_mode == "f2d":
            template = (None, "FT", None)
        elif pol.moe_mode == "ep_pad":
            template = ("F!", "T", None)
        else:
            template = (("T", "F", None) if expert_parallel
                        else (None, "T", "F"))
    offset = len(shape) - len(template)
    out = [None] * len(shape)
    for i, t in enumerate(template):
        dim = shape[offset + i]
        uneven_ok = False
        if t == "T":
            ax = pol.tp
        elif t == "F":
            ax = pol.fsdp_axes
        elif t == "F!":                      # uneven shards allowed
            ax = pol.dp
            uneven_ok = True
        elif t == "FT":
            ax = tuple(pol.dp) + (pol.tp,)
        else:
            ax = None
        if ax is not None and not uneven_ok and dim % pol.axis_size(ax) != 0:
            ax = None                        # divisibility fallback
        out[offset + i] = ax
    return P(*out)


def build_param_specs(param_shapes: PyTree, pol: ShardPolicy,
                      n_experts: int = 0) -> PyTree:
    """A spec per parameter (any leaf with ``.shape``), in the tree's
    structure."""
    expert_parallel = n_experts >= pol.sizes["model"]

    def one(path, leaf):
        for pat, template in _PARAM_RULES:
            if re.search(pat, path):
                return _resolve(template, pol, tuple(leaf.shape),
                                expert_parallel)
        return P(*([None] * len(leaf.shape)))

    return tree_unflatten(param_shapes, [one(path, leaf) for path, leaf
                                         in tree_items(param_shapes)])


def build_batch_specs(batch_shapes: PyTree, pol: ShardPolicy) -> PyTree:
    """Batch dim (leading) over dp when divisible, else replicated."""
    dp = pol.dp
    dp_size = pol.axis_size(dp)

    def one(leaf):
        spec = [None] * len(leaf.shape)
        if leaf.shape and leaf.shape[0] % dp_size == 0:
            spec[0] = dp
        return P(*spec)

    return tree_unflatten(batch_shapes,
                          [one(leaf) for _, leaf in tree_items(batch_shapes)])


def build_cache_specs(cache_shapes: PyTree, pol: ShardPolicy) -> PyTree:
    """Decode caches: leaves are (B, ...).  Shard B over dp when divisible;
    otherwise (long context, B=1) shard the longest trailing dim over dp
    (sequence/context parallelism for the KV ring).  KV-cache leaves (B,
    S, K, hd) also shard hd over model."""
    dp = pol.dp
    dp_size = pol.axis_size(dp)
    tp = pol.tp
    tp_size = pol.axis_size(tp)

    def one(leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if len(shape) >= 1 and shape[0] % dp_size == 0:
            spec[0] = dp
        elif len(shape) > 1:
            order = sorted(range(1, len(shape)), key=lambda i: -shape[i])
            for i in order:
                if shape[i] % dp_size == 0 and shape[i] >= dp_size:
                    spec[i] = dp
                    break
        if len(shape) == 4 and shape[-1] % tp_size == 0 and spec[-1] is None:
            spec[-1] = tp
        return P(*spec)

    return tree_unflatten(cache_shapes,
                          [one(leaf) for _, leaf in tree_items(cache_shapes)])


def placements(mesh, spec: P) -> list:
    """The DTensor placements of ``spec`` on ``mesh`` (the reference's
    ``NamedSharding(mesh, spec)``)."""
    return spec_placements(spec, mesh)


def named(mesh, specs: PyTree) -> PyTree:
    """A tree of placements, one per spec of ``specs``."""
    return tree_unflatten(specs, [placements(mesh, s)
                                  for _, s in tree_items(specs)])


def distribute(tree: PyTree, mesh, specs: PyTree) -> PyTree:
    """Every tensor of ``tree`` as a DTensor on ``mesh`` sharded by its
    spec (same structure as ``tree``); other leaves unchanged.  A leaf
    that requires grad stays one."""
    from torch.distributed.tensor import distribute_tensor
    spec_of = dict(tree_items(specs))
    out = []
    for path, leaf in tree_items(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = distribute_tensor(leaf.detach(), mesh,
                                     placements(mesh, spec_of[path])
                                     ).requires_grad_(leaf.requires_grad)
        out.append(leaf)
    return tree_unflatten(tree, out)


def local_bytes(tree: PyTree, mesh, specs: PyTree) -> int:
    """Bytes of rank 0's shards of ``tree`` under ``specs``, from the
    arithmetic alone: a dim split ``n`` ways holds ``ceil(dim / n)`` on
    rank 0."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    spec_of = dict(tree_items(specs))
    total = 0
    for path, leaf in tree_items(tree):
        if not isinstance(leaf, torch.Tensor):
            continue
        n = 1
        for dim, entry in zip(leaf.shape, spec_of[path]):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            ways = 1
            for a in axes:
                ways *= sizes[a]
            n *= -(-dim // ways)
        total += n * leaf.element_size()
    return total


# what DTensor says when it has no plan for an op on these placements;
# any other error is the op's own and is raised as it is
_REFUSALS = ("does not have a sharding strategy", "unevenly",
             "not evenly divisible", "without redistribution")
# what a view says of a local shard whose strides DTensor left
# non-contiguous: the global shapes have passed its sharding propagation
_LAYOUT = "view size is not compatible with input tensor's size and stride"
_DTENSOR = os.path.join("torch", "distributed", "tensor", "")


def _refused(err: BaseException | None) -> bool:
    """DTensor's own refusal: an error of ``err``'s chain raised inside
    DTensor that says it has no strategy for the op or cannot split a dim
    evenly (in torch 2.11 also: that a reshape over a sharded dim cannot
    be done without redistribution), or a view that DTensor ran on a
    local shard it laid out with strides the view cannot take."""
    while err is not None:
        frames = traceback.extract_tb(err.__traceback__)
        if frames and ((_DTENSOR in frames[-1].filename
                        and any(m in str(err) for m in _REFUSALS))
                       or (_LAYOUT in str(err)
                           and any(_DTENSOR in f.filename for f in frames))):
            return True
        err = err.__cause__
    return False


class ReshardFallbacks(TorchDispatchMode):
    """What GSPMD does implicitly and DTensor refuses, done explicitly, at
    the dispatcher (so in backwards and remat recomputes too): an op with
    DTensor inputs that DTensor refuses (no sharding strategy, such as
    ``log_sigmoid_backward``; a reshape that splits a sharded dim into
    uneven pieces, such as 9 heads over 16 ranks; a view of a local shard
    DTensor left with other strides, in mixtral's backward) runs as its
    decomposition where torch has one, else again with its inputs' shards
    of dims past the first gathered.  Each fallback is recorded in
    ``fallbacks``, and what a refused attempt counted under a
    :class:`repro_torch.counting.OpCounter` is forgotten.  Any other error,
    and a refusal that both fallbacks meet too, is raised: inputs are never
    replicated whole to get past it."""

    def __init__(self):
        super().__init__()
        self.fallbacks: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        counter = counting.active()
        snap = counter.snapshot() if counter is not None else None
        attempts = [("", lambda: func(*args, **kwargs))]
        if func in decomposition_table and not func.is_view:
            attempts.append(("decompose", lambda: decomposition_table[func](
                *args, **kwargs)))
        attempts.append(("gather", lambda: func(*tree_map_only(
            DTensor, _gather_past_batch, args), **kwargs)))
        for i, (how, attempt) in enumerate(attempts):
            try:
                out = attempt()
            except Exception as e:
                if not _refused(e) or i == len(attempts) - 1:
                    raise
                if counter is not None:
                    counter.restore(snap)
                continue
            if how:
                self.fallbacks[f"{how}:{func}"] += 1
            return out


def _gather_past_batch(x):
    """``x`` with its shards of tensor dims past the first gathered."""
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_shard() and p.dim > 0 else p
        for p in x.placements])


def clear_sharding_cache() -> None:
    """Forget DTensor's cached sharding decisions and output shapes: its
    cache key for ``topk`` leaves out ``k``, so a model of another top-k
    earlier in the process gave a later ``topk`` the wrong shape.  The dry
    run clears them before every mixture-of-experts combo (a clear costs
    the next combo ~40% more time)."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    for cache in (prop.propagate_op_sharding,
                  getattr(type(prop), "_propagate_tensor_meta_cached", None)):
        if hasattr(cache, "cache_clear"):
            cache.cache_clear()
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                     None)
    if native is not None:             # the C++ fast path's own cache
        native()
