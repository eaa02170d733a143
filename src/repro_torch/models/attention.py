"""GQA self-attention, the port's copy of the JAX package's
``models/attention.py``: RoPE, the chunked plain attention, the attention
block with its ``use_flash_kernel`` route, and the serving path: the KV
cache (a ring buffer under a sliding window), the one-pass prefill that
builds it and the one-token decode against it.

Layouts are the reference's: activations ``(B, S, H, hd)`` inside the
block, ``(B, H, S, hd)`` at the flash kernel, caches ``(B, S_max, K,
hd)``.  The prefill attends through :func:`gqa_attention`, as the
reference's does, and so does cross-attention onto the frontend's
(vision) embeddings: no RoPE, no mask.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels import ops
from ..kernels.ref import NEG_INF
from .config import ModelConfig
from .layers import dense_init


def rope_frequencies(head_dim: int, theta: float, fraction: float = 1.0,
                     device: torch.device | str | None = None):
    """Inverse frequencies (rot/2,) in float32 and the rotated width."""
    rot = int(head_dim * fraction) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps), rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x (B, S, H, hd); positions (B, S) or (S,).  Rotates the pairs of
    INTERLEAVED lanes ``(x[..., 0::2], x[..., 1::2])`` of the first
    ``fraction * hd`` dims in float32, as the reference does (not Hugging
    Face's ``rotate_half`` halves), and casts back."""
    hd = x.shape[-1]
    inv, rot = rope_frequencies(hd, theta, fraction, x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * inv                  # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    rotated = torch.stack([out1, out2], dim=-1).reshape(x[..., :rot].shape)
    return torch.cat([rotated.to(x.dtype), x[..., rot:]], dim=-1)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int | None) -> torch.Tensor:
    """(Sq, Sk) additive float32 bias: 0 where a query may attend, -1e30
    elsewhere."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return torch.where(ok, 0.0, NEG_INF)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                  window: int | None = None,
                  q_chunk: int = 1024) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Sk, K, hd) with H % K == 0: query head h
    reads KV head h // (H // K).  Full softmax in float32, in chunks of
    ``q_chunk`` queries so the (Sq, Sk) scores never fully materialize."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    g = H // K
    scale = 1.0 / math.sqrt(hd)
    qh = q.reshape(B, Sq, K, g, hd)
    kf, vf = k.float(), v.float()

    def chunk_fn(qc, qp):
        s = torch.einsum("bckgh,bskh->bckgs", qc.float(), kf) * scale
        s = s + _mask_bias(qp, k_pos, causal, window)[None, :, None, None, :]
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bckgs,bskh->bckgh", p, vf)

    out = torch.cat([chunk_fn(qh[:, i:i + q_chunk], q_pos[i:i + q_chunk])
                     for i in range(0, Sq, q_chunk)], dim=1)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def init_attention(generator: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype, cross: bool = False) -> dict:
    """wq, wk, wv, wo (and the QKV biases under ``cfg.qkv_bias``); a
    cross-attention block (``cross``) draws the same four matrices, its
    keys and values projecting the frontend's embeddings."""
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": dense_init(generator, D, H * hd, dtype),
         "wk": dense_init(generator, D, K * hd, dtype),
         "wv": dense_init(generator, D, K * hd, dtype),
         "wo": dense_init(generator, H * hd, D, dtype,
                          scale=1.0 / math.sqrt(H * hd))}
    if cfg.qkv_bias:
        dev = generator.device
        p["wq_bias"] = torch.zeros((H * hd,), dtype=dtype, device=dev)
        p["wk_bias"] = torch.zeros((K * hd,), dtype=dtype, device=dev)
        p["wv_bias"] = torch.zeros((K * hd,), dtype=dtype, device=dev)
    return p


def _project_qkv(p: dict, x: torch.Tensor, ctx: torch.Tensor,
                 cfg: ModelConfig):
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = ctx @ p["wk"]
    v = ctx @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["wq_bias"]
        k = k + p["wk_bias"]
        v = v + p["wv_bias"]
    return (q.reshape(B, S, H, hd), k.reshape(B, ctx.shape[1], K, hd),
            v.reshape(B, ctx.shape[1], K, hd))


def _rope_qk(q, k, positions, cfg: ModelConfig):
    if cfg.rope_style == "none":
        return q, k
    frac = cfg.rope_fraction if cfg.rope_style == "partial" else 1.0
    return (apply_rope(q, positions, cfg.rope_theta, frac),
            apply_rope(k, positions, cfg.rope_theta, frac))


def attention_block(p: dict, x: torch.Tensor, *, cfg: ModelConfig,
                    positions: torch.Tensor, q_chunk: int = 1024,
                    shard=None) -> torch.Tensor:
    """Full-sequence self-attention (training).  With
    ``cfg.use_flash_kernel`` the attention itself is
    :func:`repro_torch.kernels.ops.flash_attention` (the CUDA kernels on
    the card, their plain versions on the CPU), else
    :func:`gqa_attention`.  ``shard`` (:class:`repro_torch.models.
    ShardHints`): K and V are gathered to full sequences once per layer."""
    q, k, v = _project_qkv(p, x, x, cfg)
    if shard is not None and x.shape[1] > 1:
        # K/V full-sequence inside each q-chunk: one gather per layer
        # instead of partial sums over a model-sharded S in every chunk
        k = shard.constrain(k, (shard.dp, None, None, None))
        v = shard.constrain(v, (shard.dp, None, None, None))
    q, k = _rope_qk(q, k, positions, cfg)
    pos1d = positions if positions.dim() == 1 else positions[0]
    if cfg.use_flash_kernel:
        out = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=cfg.causal, window=cfg.sliding_window).transpose(1, 2)
    else:
        out = gqa_attention(q, k, v, q_pos=pos1d, k_pos=pos1d,
                            causal=cfg.causal, window=cfg.sliding_window,
                            q_chunk=q_chunk)
    return out.reshape(x.shape[0], x.shape[1], -1) @ p["wo"]


def cross_attention_block(p: dict, x: torch.Tensor, vision: torch.Tensor, *,
                          cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention of x (B, Sq, D) onto the frontend's embeddings
    vision (B, Sk, D), llama-3.2-vision style: no RoPE, no causality over
    the context, through :func:`gqa_attention` in chunks of 4,096
    queries."""
    q, k, v = _project_qkv(p, x, vision, cfg)
    Sq, Sk = x.shape[1], vision.shape[1]
    out = gqa_attention(q, k, v, q_pos=torch.arange(Sq, device=x.device),
                        k_pos=torch.arange(Sk, device=x.device),
                        causal=False, window=None, q_chunk=4096)
    return out.reshape(x.shape[0], Sq, -1) @ p["wo"]


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_max, K, hd)
    v: torch.Tensor
    length: torch.Tensor     # (B,) int32, the current fill


def attention_prefill(p: dict, x: torch.Tensor, *, cfg: ModelConfig,
                      positions: torch.Tensor, max_len: int,
                      q_chunk: int = 1024) -> tuple[torch.Tensor, KVCache]:
    """Full-sequence attention that also builds the decode cache in one
    pass.  Under a sliding window the cache holds the last ``window`` keys
    and values in ring order, as token-by-token decode would have left
    them."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, x, cfg)
    q, k = _rope_qk(q, k, positions, cfg)
    pos1d = positions if positions.dim() == 1 else positions[0]
    out = gqa_attention(q, k, v, q_pos=pos1d, k_pos=pos1d, causal=cfg.causal,
                        window=cfg.sliding_window, q_chunk=q_chunk)
    out = out.reshape(B, S, -1) @ p["wo"]

    window = cfg.sliding_window
    S_max = min(max_len, window) if window else max_len
    if window and S >= S_max:
        perm = torch.remainder(torch.arange(S_max, device=x.device) - S, S_max)
        k_cache = k[:, -S_max:][:, perm]        # slot -> tail index
        v_cache = v[:, -S_max:][:, perm]
    else:
        pad = S_max - min(S, S_max)
        k_cache = torch.nn.functional.pad(k[:, :S_max], (0, 0, 0, 0, 0, pad))
        v_cache = torch.nn.functional.pad(v[:, :S_max], (0, 0, 0, 0, 0, pad))
    length = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return out, KVCache(k_cache, v_cache, length)


def attention_decode(p: dict, x: torch.Tensor, cache: KVCache, *,
                     cfg: ModelConfig, shard=None
                     ) -> tuple[torch.Tensor, KVCache]:
    """One-token decode: x (B, 1, D) against a (possibly windowed) cache.
    The new key and value go to slot ``length % S_max`` (a ring buffer);
    scores and softmax in float32 over the valid slots.

    ``shard`` (:class:`repro_torch.models.ShardHints`): the query heads are
    grouped over the KV heads on local shards.  The query takes the
    cache's layout (its batch and head-dim shards), so the grouping
    reshape splits no sharded dim (chatglm3-6b's 2 KV heads over 16 model
    ranks left DTensor a local reshape it could not do); the scores' sums
    over head-dim shards are reduced before the mask and the softmax, and
    the output is gathered over them before its heads are flattened.
    Each move is counted in ``shard.reshards``."""
    B = x.shape[0]
    pos = cache.length.long()                              # (B,)
    q, k_new, v_new = _project_qkv(p, x, x, cfg)
    q, k_new = _rope_qk(q, k_new, pos[:, None], cfg)

    S_max = cache.k.shape[1]
    slot = pos % S_max
    idx = torch.arange(S_max, device=x.device)[None, :]
    sel = (idx == slot[:, None])[:, :, None, None]         # (B, S_max, 1, 1)
    k_cache = torch.where(sel, k_new[:, 0][:, None], cache.k)
    v_cache = torch.where(sel, v_new[:, 0][:, None], cache.v)

    # slot i holds absolute position pos - ((slot - i) mod S_max)
    abs_pos = pos[:, None] - torch.remainder(slot[:, None] - idx, S_max)
    valid = (abs_pos >= 0) & (abs_pos <= pos[:, None])
    if cfg.sliding_window is not None:
        valid &= abs_pos > (pos[:, None] - cfg.sliding_window)

    K, hd = cfg.n_kv_heads, cfg.hd
    g = cfg.n_heads // K
    if shard is not None:
        q = shard.regroup(q, k_cache, {0: 0, 3: 3}, "decode_q")
    qh = q.reshape(B, K, g, hd)
    # products of the cache's dtype, summed in float32
    s = torch.einsum("bkgh,bskh->bkgs", qh.float(), k_cache.float()) \
        / math.sqrt(hd)
    if shard is not None:
        s = shard.regroup(s, k_cache, {0: 0, 1: 3}, "decode_scores")
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", pr.to(v_cache.dtype).float(),
                       v_cache.float())
    if shard is not None:
        out = shard.regroup(out, v_cache, {0: 0}, "decode_out")
    out = out.reshape(B, 1, -1).to(x.dtype) @ p["wo"]
    return out, KVCache(k_cache, v_cache, cache.length + 1)


def init_kv_cache(cfg: ModelConfig, batch: int, seq_len: int,
                  dtype: torch.dtype = torch.bfloat16, *,
                  device: torch.device | str = "cuda") -> KVCache:
    """A zero cache of ``seq_len`` slots (``window`` under a sliding
    window) whose length reads ``seq_len``, as the reference's does; a
    decode replay from the start resets the length to 0."""
    S = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    shape = (batch, S, cfg.n_kv_heads, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.full((batch,), seq_len, dtype=torch.int32,
                              device=device))
