"""The federator's weighted merge: the CUDA kernel ``csrc/weighted_agg.cu``
and its plain PyTorch versions.

One launch merges ``E`` edges at once: ``(E, C, D)`` client vectors and
``(E, C)`` weights give ``(E, D)``, each edge's weights normalized as
``w / max(sum(w), 1e-12)`` inside the kernel; the flat merge of ``P``
clients is the one-edge case.  :func:`repro_torch.kernels.ops.
weighted_average_flat` and ``weighted_average_edges`` route to it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import (weighted_agg_edges_ref,  # noqa: F401 (the plain versions)
                  weighted_agg_ref)

# the kernel keeps an edge's C normalized weights in shared memory
_MAX_SMEM_BYTES = 48 * 1024

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_void_p]


def weighted_agg_cuda(stacked: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """stacked (E, C, D), weights (E, C) -> (E, D): launch the merge kernel
    on the current stream (no synchronize)."""
    if stacked.dim() != 3:
        raise ValueError(f"weighted_agg: stacked must be (E, C, D), got "
                         f"shape {tuple(stacked.shape)}")
    E, C, D = stacked.shape
    device = stacked.device
    _build.check_cuda_inputs("weighted_agg", device,
                             stacked=(stacked, (E, C, D)),
                             weights=(weights, (E, C)))
    if 4 * C > _MAX_SMEM_BYTES:
        raise ValueError(f"weighted_agg: {C} clients per edge exceed the "
                         "kernel's shared-memory stage")
    out = torch.empty((E, D), dtype=torch.float32, device=device)
    if E * D == 0:
        return out
    fn = _build.kernel_function("weighted_agg", "weighted_agg_f32", _ARGTYPES)
    _build.launch("weighted_agg", "weighted_agg", fn, device,
                  stacked.data_ptr(), weights.data_ptr(), out.data_ptr(),
                  E, C, D)
    return out
