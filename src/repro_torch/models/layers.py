"""Primitive layers and the name-based sharding rules, the port's copy of
the JAX package's ``models/layers.py``: RMS norm, the dense initializer,
:class:`PartitionSpec` and the rules that derive one from a parameter's
path (:func:`partition_rules`), so that init code stays sharding-agnostic
and the launcher owns the distribution policy.

Dense weights are ``(d_in, d_out)`` and applied as ``x @ W``, as in the
reference, so that parameters carry across without a transpose.  The
port's parameter tree keeps one dict per repetition of the pattern
(``layers/<i>/pos<j>/...``) where the reference stacks every layer leaf
over a leading ``n_rep`` axis, so a port leaf has one dim fewer and its
spec is the reference's with that leading ``None`` dropped.
"""
from __future__ import annotations

import math
import re

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm computed in float32 and cast back to ``x``'s dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, scale: float | None = None) -> torch.Tensor:
    """A ``(d_in, d_out)`` weight: standard normal draws in float32 on the
    generator's device, times ``scale`` (default ``1 / sqrt(d_in)``), cast
    to ``dtype``."""
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (w * s).to(dtype)


# ---------------------------------------------------------------------------
# partitioning rules
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """The reference's ``jax.sharding.PartitionSpec`` as a plain value: one
    entry per tensor dim, each ``None`` (replicated), a mesh axis name, or
    a tuple of names (the dim split over those axes, major to minor).  A
    tuple of one name is that name, as JAX normalizes it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# Matched against '/'-joined param paths, first hit wins.  The trailing
# dims of the spec align with the trailing dims of the tensor.
_RULES: list[tuple[str, tuple]] = [
    (r"embed$",               ("model", None)),       # (V, D) vocab-sharded
    (r"lm_head$",             (None, "model")),       # (D, V)
    (r"in_proj$",             (None, None)),          # audio input proj
    (r"(wq|wk|wv)$",          (None, "model")),       # (D, H*hd) head-sharded
    (r"(wq|wk|wv)_bias$",     ("model",)),
    (r"wo$",                  ("model", None)),        # (H*hd, D)
    (r"router$",              (None, None)),           # (D, E) replicated
    (r"experts/(w_gate|w_up)$",   ("expert_or_ff",)),  # resolved below
    (r"experts/w_down$",          ("expert_or_ff_down",)),
    (r"(w_gate|w_up)$",       (None, "model")),        # (D, F)
    (r"w_down$",              ("model", None)),        # (F, D)
    (r"(ssm_in|ssm_gate)$",   (None, "model")),        # (D, d_inner)
    (r"ssm_out$",             ("model", None)),        # (d_inner, D)
    (r"(ssm_dt|ssm_bc)$",     ("model", None)),        # (d_inner, .)
    (r"ssm_a$",               ("model", None)),        # (d_inner, state)
    (r"ssm_conv$",            ("model", None)),        # (d_inner, k)
    (r"(ssm_d|ssm_dt_bias)$", ("model",)),
    (r"(gate_i|gate_f|gate_o)$", (None, None)),        # small gate projs
    (r"slstm_(wx|wh)$",       (None, "model")),
    (r"slstm_out$",           ("model", None)),
    (r".*(norm|scale|bias)$", (None,)),
]


def partition_rules(path: str, ndim: int, *,
                    expert_sharded: bool) -> PartitionSpec:
    """Spec for one param.  ``expert_sharded``: experts >= model-axis size,
    so the expert dim is sharded; otherwise shard each expert's d_ff."""
    for pat, spec in _RULES:
        if re.search(pat, path):
            if spec == ("expert_or_ff",):          # (E, D, F)
                spec = (("model", None, None) if expert_sharded
                        else (None, None, "model"))
            elif spec == ("expert_or_ff_down",):   # (E, F, D)
                spec = (("model", None, None) if expert_sharded
                        else (None, "model", None))
            pad = (None,) * (ndim - len(spec))
            return P(*(pad + tuple(spec)))
    return P(*((None,) * ndim))


def tree_paths(tree):
    """A tree of '/'-joined key paths, same structure as ``tree``."""
    from .model import tree_items, tree_unflatten
    return tree_unflatten(tree, [path for path, _ in tree_items(tree)])


def build_param_specs(params, *, expert_sharded: bool):
    """A spec per parameter by :func:`partition_rules`, in the params'
    tree structure."""
    from .model import tree_items, tree_unflatten
    return tree_unflatten(params, [
        partition_rules(path, leaf.dim(), expert_sharded=expert_sharded)
        for path, leaf in tree_items(params)])


def spec_placements(spec, mesh) -> list:
    """DTensor placements (one per *mesh* dim) of a spec (one entry per
    *tensor* dim): ``Shard(d)`` on every mesh axis that tensor dim ``d``
    names, ``Replicate()`` on the others.  A dim split over several axes
    is split major to minor in mesh order, as DTensor shards it; a spec
    that names them in another order, or names an axis twice, raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) or any(out[i] != Replicate() for i in idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in the mesh's order {names} or repeat")
        for i in idx:
            out[i] = Shard(d)
    return out
