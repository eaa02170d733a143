"""The least work of one launch of each kernel: ``(bytes, flops)``.

Bytes count each input read once and each output written once; flops
count the operations the function needs on this call's inputs (for the
flash kernels, the products over the visible (query, key) pairs only).
One formula serves the kernel's bound on the card (``chip_smoke.py``'s
kernel lines) and the roofline's count of a step
(:mod:`repro_torch.counting`).
"""
from __future__ import annotations

import numpy as np
import torch

F32 = 4
# products over the head dim per visible (query, key) pair: the forward
# S = QK^T and PV; dq recomputes S, then dP = dO V^T and dQ = dS K; dk/dv
# recomputes S and dP, then dV = P^T dO and dK = dS^T Q
FLASH_PRODUCTS = {"fwd": 2, "dq": 3, "dkv": 4}


def visible_pairs(sq: int, kv_len: int, causal: bool,
                  window: int | None) -> int:
    """(query, key) pairs one head attends: query i < ``sq`` sees keys j <
    ``kv_len`` with j <= i when causal and j > i - window under a window."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(kv_len, i + 1) if causal else np.full(sq, kv_len)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash_attention(kind: str, bh: int, sq: int, hd: int, dtype: torch.dtype,
                    *, causal: bool, window: int | None,
                    kv_len: int) -> tuple[int, int]:
    """``kind`` "fwd", "dq" or "dkv" over ``bh`` heads of ``sq`` queries
    and ``kv_len`` keys of head dim ``hd`` in ``dtype``: the forward reads
    q, k, v and writes out and the float32 lse; dq reads q, k, v, dO, lse
    and delta and writes dq in float32; dk/dv reads the same and writes dk
    and dv in float32."""
    es = torch.empty((), dtype=dtype).element_size()
    q_el, k_el = bh * sq * hd, bh * kv_len * hd
    reads = es * (2 * q_el + 2 * k_el)          # q, k, v and out or dO
    n_bytes = {"fwd": reads + F32 * bh * sq,
               "dq": reads + 2 * F32 * bh * sq + F32 * q_el,
               "dkv": reads + 2 * F32 * bh * sq + 2 * F32 * k_el}[kind]
    pairs = bh * visible_pairs(sq, kv_len, causal, window)
    return n_bytes, FLASH_PRODUCTS[kind] * 2 * hd * pairs


def mlstm_chunk(bh: int, s: int, hd: int, chunk: int) -> tuple[int, int]:
    """The chunkwise mLSTM, float32: q, k, v and h (BH, S, hd), the two
    log gates, and the final C, n and m; the state products (the C update
    and q C over every chunk but the reads of the first) and the causal
    halves of q k^T and S v within each chunk."""
    nch = s // chunk
    flops = bh * (2 * chunk * hd * hd * (2 * nch - 1)
                  + 2 * 2 * hd * nch * chunk * (chunk + 1) // 2)
    n_bytes = F32 * (4 * bh * s * hd + 2 * bh * s + bh * hd * hd + bh * hd
                     + bh)
    return n_bytes, flops


def weighted_agg(e: int, c: int, d: int) -> tuple[int, int]:
    """``e`` edges of ``c`` client vectors of ``d`` floats and their
    weights in, the ``e`` merged vectors out; a multiply-add per value."""
    return F32 * (e * c * d + e * c + e * d), 2 * e * c * d


def vgm_encode(n: int, q: int, k: int) -> tuple[int, int]:
    """``n`` rows of ``q`` columns of ``k`` modes: x, the params and the
    Gumbels in, the slots (or a column's alphas and betas) out."""
    return (F32 * (n * q + 3 * q * k + n * q * k + n * q * (1 + k)),
            n * q * (9 * k + 4))


def vgm_decode_table(b: int, q: int, k: int) -> tuple[int, int]:
    """``b`` rows of ``q`` columns' (1 + k) slots and the modes' means and
    stds in, the decoded values out."""
    return F32 * (b * q * (1 + k) + 2 * q * k + b * q), b * q * (k + 4)


def segment_activations(b: int, s: int, w: int,
                        backward: bool = False) -> tuple[int, int]:
    """``b`` rows of ``s`` spans of ``w`` lanes: logits, uniforms and the
    kinds in, the activations out; the backward also reads the cotangent
    and writes the gradient."""
    if backward:
        return F32 * (4 * b * s * w + s * w), b * s * w * 16
    return F32 * (3 * b * s * w + s * w), b * s * w * 12
