"""Table-wide VGM encode: the CUDA kernel ``csrc/vgm_encode.cu`` and its
plain PyTorch version.

Both take every continuous column at once: ``x_cols (N, Q)``, packed
``(Q, Kmax)`` mode params (padded modes carry log-weight ``-1e30``, mean 0,
std 1; see :func:`repro_torch.tabular.vgm.pack_vgm_params`) and pre-drawn
Gumbel noise ``(N, Q*Kmax)``; both return the slots ``(N, Q*(1+Kmax))``,
column ``q`` holding ``[alpha, beta_0 .. beta_{Kmax-1}]`` at ``q*(1+Kmax)``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import vgm_encode_table_ref  # noqa: F401  (the plain version)

# the kernel stages 4 (Q, Kmax) float tables in shared memory
_MAX_SMEM_BYTES = 48 * 1024

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]


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
