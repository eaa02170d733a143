"""The feed-forward blocks, the port's copy of the JAX package's
``models/moe.py``: the dense SwiGLU FFN and the mixture-of-experts FFN
with capacity-bounded, sort-free dispatch.

Dispatch is scatter / gather (no (T, E, C) one-hot product): tokens are
routed top-k by a float32 router, each batch row is its own group, a
token's position inside its expert comes from a cumulative count over the
row, and what overflows the expert's capacity is dropped (Switch / GShard
semantics).  Dropped rows are zeroed before the scatter, so every buffer
slot receives at most one nonzero row and the scatter's sum does not
depend on the order of its additions: the CUDA ``scatter_add_`` is
deterministic here.  The three expert products stay ``torch.einsum``, as
the reference leaves them to XLA.  Under ``shard`` hints (a
:class:`repro_torch.models.ShardHints` over a DTensor mesh) the tokens are
gathered before the dispatch and the expert weights used column-parallel
(gate, up) and row-parallel (down), as the reference constrains them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import dense_init


def _expert_stack(generator: torch.Generator, n: int, d_in: int, d_out: int,
                  scale: float, dtype: torch.dtype) -> torch.Tensor:
    """An ``(n, d_in, d_out)`` stack of standard normal draws times
    ``scale``, drawn in float32 one expert at a time (a whole stack in
    float32 would add up to 21.5 GB at llama4-maverick's widths) and cast
    to ``dtype``."""
    out = torch.empty((n, d_in, d_out), dtype=dtype, device=generator.device)
    for e in range(n):
        w = torch.randn((d_in, d_out), generator=generator,
                        device=generator.device, dtype=torch.float32)
        out[e] = w * scale
    return out


def init_moe(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> dict:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s_in, s_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Fd)
    return {
        "router": dense_init(generator, D, E, torch.float32),   # fp32 router
        "experts": {
            "w_gate": _expert_stack(generator, E, D, Fd, s_in, dtype),
            "w_up": _expert_stack(generator, E, D, Fd, s_in, dtype),
            "w_down": _expert_stack(generator, E, Fd, D, s_out, dtype),
        },
    }


def init_dense_ffn(generator: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    s_in, s_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Fd)
    return {"w_gate": dense_init(generator, D, Fd, dtype, s_in),
            "w_up": dense_init(generator, D, Fd, dtype, s_in),
            "w_down": dense_init(generator, Fd, D, dtype, s_out)}


def dense_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x W_gate) * (x W_up)) W_down``."""
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor
    dropped_fraction: torch.Tensor


class MoERouting(NamedTuple):
    """Where each (token, choice) of a batch goes: ``gate`` (B, S, K) the
    renormalized top-k gates, ``expert_idx`` (B, S, K), and over the
    token-major flattening (B, S*K): ``keep`` (inside the expert's
    capacity) and ``dest`` (its slot in the (E * cap) buffer); ``cap``
    slots per expert and row; ``aux`` the Switch load-balance loss."""
    gate: torch.Tensor
    expert_idx: torch.Tensor
    keep: torch.Tensor
    dest: torch.Tensor
    cap: int
    aux: torch.Tensor


def capacity(cfg: ModelConfig, S: int) -> int:
    """Slots per expert and batch row: ``int(S*K/E*capacity_factor) + 1``,
    rounded up to a multiple of 128 once it reaches 128."""
    cap = int(S * cfg.top_k / cfg.n_experts * cfg.capacity_factor) + 1
    if cap >= 128:
        cap = -(-cap // 128) * 128
    return cap


def moe_route(p: dict, x: torch.Tensor, cfg: ModelConfig) -> MoERouting:
    """The router of :func:`moe_ffn` for x (B, S, D): float32 logits,
    softmax, ``topk``, the top-k gates renormalized by ``max(sum, 1e-9)``,
    the aux loss ``E * sum(mean(probs) * mean(onehot(top1)))`` and each
    choice's slot from an exclusive cumulative count over the row."""
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    probs = torch.softmax(x.float() @ p["router"], dim=-1)      # (B, S, E)
    gate, expert_idx = torch.topk(probs, K, dim=-1)             # (B, S, K)
    gate = gate / torch.clamp(torch.sum(gate, -1, keepdim=True), min=1e-9)

    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(F.one_hot(expert_idx[..., 0], E).float(), dim=(0, 1))
    aux = E * torch.sum(me * ce)

    cap = capacity(cfg, S)
    flat_expert = expert_idx.reshape(B, S * K)                  # token-major
    onehot = F.one_hot(flat_expert, E)                          # (B, SK, E)
    before = torch.cumsum(onehot, dim=1) - onehot
    pos = torch.gather(before, 2, flat_expert[..., None])[..., 0]
    keep = pos < cap
    dest = flat_expert * cap + torch.clamp(pos, max=cap - 1)
    return MoERouting(gate, expert_idx, keep, dest, cap, aux)


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig, shard=None
            ) -> tuple[torch.Tensor, MoEMetrics]:
    """x (B, S, D) -> (B, S, D) and :class:`MoEMetrics`.  Group-local
    dispatch: routing, capacity and the scatter are per batch row.  Each
    kept (token, choice) is copied into its expert's slot (dropped ones
    as zeros), the experts run SwiGLU over their (cap, D) buffers, and
    each token sums its choices' outputs times their gates."""
    B, S, D = x.shape
    K = cfg.top_k
    if shard is not None and S > 1:
        # tokens gathered over the model axis before the dispatch: one
        # all-gather of (B, S, D) beats reducing the scatter's output
        x = shard.constrain(x, (shard.dp, None, None))
    r = moe_route(p, x, cfg)
    E, cap = cfg.n_experts, r.cap
    src = torch.repeat_interleave(x, K, dim=1)                  # (B, SK, D)
    src = torch.where(r.keep[..., None], src, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))
    index = r.dest[..., None].expand(B, S * K, D)
    buf = torch.zeros((B, E * cap, D), dtype=x.dtype, device=x.device)
    buf = buf.scatter_add(1, index, src)
    h = buf.reshape(B, E, cap, D)

    w = p["experts"]
    wg, wu, wd = w["w_gate"], w["w_up"], w["w_down"]
    if shard is not None:
        # column-parallel gate/up, row-parallel down: contraction dims
        # unsharded, the data-axis storage shards gathered per layer
        h = shard.constrain(h, (shard.dp, None, None, None))
        wg = shard.constrain(wg, (None, None, shard.tp))
        wu = shard.constrain(wu, (None, None, shard.tp))
        wd = shard.constrain(wd, (None, shard.tp, None))
    act = F.silu(torch.einsum("becd,edf->becf", h, wg))
    act = act * torch.einsum("becd,edf->becf", h, wu)
    out_buf = torch.einsum("becf,efd->becd", act, wd).reshape(
        B, E * cap, D)

    gathered = torch.gather(out_buf, 1, index)
    gathered = gathered * (r.gate.reshape(B, S * K) * r.keep)[..., None].to(
        x.dtype)
    out = torch.sum(gathered.reshape(B, S, K, D), dim=2)
    dropped = 1.0 - torch.mean(r.keep.float())
    return out, MoEMetrics(r.aux, dropped)
