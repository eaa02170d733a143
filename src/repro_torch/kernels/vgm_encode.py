"""VGM encode: the CUDA kernels of ``csrc/vgm_encode.cu`` and their plain
PyTorch versions.

The table-wide kernel takes every continuous column at once: ``x_cols
(N, Q)``, packed ``(Q, Kmax)`` mode params (padded modes carry log-weight
``-1e30``, mean 0, std 1; see :func:`repro_torch.tabular.vgm.
pack_vgm_params`) and pre-drawn Gumbel noise ``(N, Q*Kmax)``; it and its
plain version return the slots ``(N, Q*(1+Kmax))``,
column ``q`` holding ``[alpha, beta_0 .. beta_{Kmax-1}]`` at ``q*(1+Kmax)``.
The single-column kernel, the per-column ``encode_loop``'s, takes ``x
(N,)``, the column's ``(K,)`` params and Gumbels ``(N, K)`` and returns
``alpha (N,)`` and ``beta (N, K)``.

Both entries launch one block per tile of consecutive rows (see
``csrc/vgm_encode.cu``); :func:`encode_plan` sizes the tiles and the
blocks, and the kernel follows the plan.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .ref import (vgm_encode_ref,  # noqa: F401  (the plain versions)
                  vgm_encode_table_ref)

# threads a block may have (``kMaxThreads`` in csrc/vgm_encode.cu)
MAX_THREADS = 256
# shared memory: a block's opt-in maximum on sm_90, what a block gets
# without raising its limit, and what each of 8 resident blocks of
# ``MAX_THREADS`` threads gets of an SM's 228 KB (1 KB of each reserved)
SMEM_LIMIT = 232_448
SMEM_DEFAULT = 48 * 1024
SMEM_PER_BLOCK = 228 * 1024 // 8 - 1024
# the H100's SMs, and the tiles each should get where the rows allow
H100_SMS = 132
TILES_PER_SM = 3


class EncodePlan(NamedTuple):
    """A launch: one block of ``threads`` threads per tile, tile t holding
    rows ``[t * rows_per_tile, min((t + 1) * rows_per_tile, N))``.
    ``smem_attr`` is the block's raised shared-memory limit, 0 where
    ``smem_bytes`` fits in the default 48 KB."""
    rows_per_tile: int
    tiles: int
    threads: int
    smem_bytes: int
    smem_attr: int


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def buffer_floats(cells: int, k: int) -> int:
    """Floats of a tile buffer of ``cells`` cells of ``k`` modes: an x and
    a Gumbel stage, each with 3 floats of lead room and rounded up to 16
    bytes; the output tile (the column's alphas and betas, or the table's
    slots) has the same size.  As ``buffer_floats`` in csrc/vgm_encode.cu."""
    return _round_up(cells + 3, 4) + _round_up(cells * k + 3, 4)


def tile_smem_bytes(q: int, k: int, rows: int) -> int:
    """Shared memory of a block whose tiles hold ``rows`` rows of ``q``
    columns of ``k`` modes: the params (a float4 per mode and column), the
    input buffer and the output tile; as ``tile_smem_bytes`` in
    csrc/vgm_encode.cu."""
    return 4 * (4 * q * k + 2 * buffer_floats(rows * q, k))


def split16(offset: int, n: int) -> tuple[int, int, int, int]:
    """How the kernel moves ``n`` floats starting ``offset`` floats past a
    16-byte boundary: ``(lead, head, body, tail)``, with ``lead = offset
    % 4``, ``head`` scalar floats up to the next boundary, ``body``
    16-byte chunks and ``tail`` scalar floats after the last boundary; as
    ``split16`` in csrc/vgm_encode.cu."""
    lead = offset % 4
    head = min(n, (4 - lead) % 4)
    body = (n - head) // 4
    return lead, head, body, n - head - 4 * body


def encode_plan(n: int, q: int, k: int) -> EncodePlan:
    """The launch for ``n`` rows of ``q`` columns of ``k`` modes.  A tile
    holds at most ``MAX_THREADS`` cells, so each thread scores one cell,
    and at most ``n / (TILES_PER_SM * H100_SMS)`` rows, so every SM gets
    several tiles where the rows allow; it shrinks until 8 blocks fit on
    an SM, or to one row.  A block has as many threads as its tile has
    cells or params (it stages those once), in whole warps.  Raises where
    a one-row tile does not fit in a block's shared memory."""
    if tile_smem_bytes(q, k, 1) > SMEM_LIMIT:
        raise ValueError(
            f"vgm_encode: Q*Kmax = {q * k} mode params need "
            f"{tile_smem_bytes(q, k, 1)} bytes of shared memory for one "
            f"row, more than a block's {SMEM_LIMIT}")
    rows = max(1, min(MAX_THREADS // max(1, q),
                      -(-n // (TILES_PER_SM * H100_SMS))))
    while rows > 1 and tile_smem_bytes(q, k, rows) > SMEM_PER_BLOCK:
        rows -= 1
    smem = tile_smem_bytes(q, k, rows)
    threads = min(MAX_THREADS, _round_up(max(rows * q, q * k, 1), 32))
    return EncodePlan(rows, -(-n // rows), threads, smem,
                      smem if smem > SMEM_DEFAULT else 0)


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]
_COLUMN_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def vgm_encode_table_cuda(x_cols: torch.Tensor, means: torch.Tensor,
                          stds: torch.Tensor, log_weights: torch.Tensor,
                          gumbel: torch.Tensor) -> torch.Tensor:
    """Launch the encode kernel on the current stream (no synchronize)."""
    N, Q = x_cols.shape
    K = means.shape[1]
    device = x_cols.device
    plan = encode_plan(N, Q, K)          # raises on what no tile holds
    _build.check_cuda_inputs(
        "vgm_encode_table", device, x_cols=(x_cols, (N, Q)),
        means=(means, (Q, K)), stds=(stds, (Q, K)),
        log_weights=(log_weights, (Q, K)), gumbel=(gumbel, (N, Q * K)))
    out = torch.empty((N, Q * (1 + K)), dtype=torch.float32, device=device)
    if N * Q * K == 0:
        return out
    fn = _build.kernel_function("vgm_encode", "vgm_encode_table_f32",
                                _ARGTYPES)
    _build.launch("vgm_encode_table", "vgm_encode", fn, device,
                  x_cols.data_ptr(), means.data_ptr(), stds.data_ptr(),
                  log_weights.data_ptr(), gumbel.data_ptr(), out.data_ptr(),
                  N, Q, K, plan.rows_per_tile, plan.threads, plan.smem_bytes,
                  plan.smem_attr)
    return out


def vgm_encode_cuda(x: torch.Tensor, means: torch.Tensor, stds: torch.Tensor,
                    log_weights: torch.Tensor, gumbel: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the single-column encode kernel on the current stream (no
    synchronize): x (N,), (K,) params, gumbel (N, K) -> alpha (N,), beta
    (N, K)."""
    N, K = x.shape[0], means.shape[0]
    device = x.device
    plan = encode_plan(N, 1, K)          # raises on what no tile holds
    _build.check_cuda_inputs(
        "vgm_encode", device, x=(x, (N,)), means=(means, (K,)),
        stds=(stds, (K,)), log_weights=(log_weights, (K,)),
        gumbel=(gumbel, (N, K)))
    alpha = torch.empty((N,), dtype=torch.float32, device=device)
    beta = torch.empty((N, K), dtype=torch.float32, device=device)
    if N * K == 0:
        return alpha, beta
    fn = _build.kernel_function("vgm_encode", "vgm_encode_column_f32",
                                _COLUMN_ARGTYPES)
    _build.launch("vgm_encode", "vgm_encode", fn, device, x.data_ptr(),
                  means.data_ptr(), stds.data_ptr(), log_weights.data_ptr(),
                  gumbel.data_ptr(), alpha.data_ptr(), beta.data_ptr(), N, K,
                  plan.rows_per_tile, plan.threads, plan.smem_bytes,
                  plan.smem_attr)
    return alpha, beta
