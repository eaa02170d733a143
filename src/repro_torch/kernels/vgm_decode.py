"""Table-wide VGM decode: the CUDA kernel ``csrc/vgm_decode.cu`` and its
plain PyTorch version.

Both take the encode layout's slots ``(N, Q*(1+Kmax))`` (padded beta lanes
hold ``-1e30``) and packed ``(Q, Kmax)`` means/stds, and return the raw
continuous columns ``(N, Q)``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import vgm_decode_table_ref  # noqa: F401  (the plain version)

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]


def vgm_decode_table_cuda(slots: torch.Tensor, means: torch.Tensor,
                          stds: torch.Tensor) -> torch.Tensor:
    """Launch the decode kernel on the current stream (no synchronize)."""
    N = slots.shape[0]
    Q, K = means.shape
    device = slots.device
    _build.check_cuda_inputs(
        "vgm_decode_table", device, slots=(slots, (N, Q * (1 + K))),
        means=(means, (Q, K)), stds=(stds, (Q, K)))
    out = torch.empty((N, Q), dtype=torch.float32, device=device)
    if N * Q * K == 0:
        return out
    fn = _build.kernel_function("vgm_decode", "vgm_decode_table_f32",
                                _ARGTYPES)
    _build.launch("vgm_decode_table", "vgm_decode", fn, device,
                  slots.data_ptr(), means.data_ptr(), stds.data_ptr(),
                  out.data_ptr(), N, Q, K)
    return out
