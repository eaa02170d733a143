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
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import (vgm_encode_ref,  # noqa: F401  (the plain versions)
                  vgm_encode_table_ref)

# the kernels stage 4 (Q, Kmax) or (K,) float tables in shared memory
_MAX_SMEM_BYTES = 48 * 1024

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
_COLUMN_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_void_p]


def vgm_encode_table_cuda(x_cols: torch.Tensor, means: torch.Tensor,
                          stds: torch.Tensor, log_weights: torch.Tensor,
                          gumbel: torch.Tensor) -> torch.Tensor:
    """Launch the encode kernel on the current stream (no synchronize)."""
    N, Q = x_cols.shape
    K = means.shape[1]
    device = x_cols.device
    _build.check_cuda_inputs(
        "vgm_encode_table", device, x_cols=(x_cols, (N, Q)),
        means=(means, (Q, K)), stds=(stds, (Q, K)),
        log_weights=(log_weights, (Q, K)), gumbel=(gumbel, (N, Q * K)))
    if 16 * Q * K > _MAX_SMEM_BYTES:
        raise ValueError(f"vgm_encode_table: Q*Kmax = {Q * K} mode params "
                         f"exceed the kernel's shared-memory stage")
    out = torch.empty((N, Q * (1 + K)), dtype=torch.float32, device=device)
    if N * Q * K == 0:
        return out
    fn = _build.kernel_function("vgm_encode", "vgm_encode_table_f32",
                                _ARGTYPES)
    _build.launch("vgm_encode_table", "vgm_encode", fn, device,
                  x_cols.data_ptr(), means.data_ptr(), stds.data_ptr(),
                  log_weights.data_ptr(), gumbel.data_ptr(), out.data_ptr(),
                  N, Q, K)
    return out


def vgm_encode_cuda(x: torch.Tensor, means: torch.Tensor, stds: torch.Tensor,
                    log_weights: torch.Tensor, gumbel: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the single-column encode kernel on the current stream (no
    synchronize): x (N,), (K,) params, gumbel (N, K) -> alpha (N,), beta
    (N, K)."""
    N, K = x.shape[0], means.shape[0]
    device = x.device
    _build.check_cuda_inputs(
        "vgm_encode", device, x=(x, (N,)), means=(means, (K,)),
        stds=(stds, (K,)), log_weights=(log_weights, (K,)),
        gumbel=(gumbel, (N, K)))
    if 16 * K > _MAX_SMEM_BYTES:
        raise ValueError(f"vgm_encode: {K} mode params exceed the kernel's "
                         "shared-memory stage")
    alpha = torch.empty((N,), dtype=torch.float32, device=device)
    beta = torch.empty((N, K), dtype=torch.float32, device=device)
    if N * K == 0:
        return alpha, beta
    fn = _build.kernel_function("vgm_encode", "vgm_encode_column_f32",
                                _COLUMN_ARGTYPES)
    _build.launch("vgm_encode", "vgm_encode", fn, device, x.data_ptr(),
                  means.data_ptr(), stds.data_ptr(), log_weights.data_ptr(),
                  gumbel.data_ptr(), alpha.data_ptr(), beta.data_ptr(), N, K)
    return alpha, beta
