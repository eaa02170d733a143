"""The chunkwise mLSTM: the CUDA kernel ``csrc/mlstm_chunk_sm90.cu`` and
its plain PyTorch versions.

``mlstm_chunk_cuda`` takes q (pre-scaled by 1/sqrt(hd)), k, v ``(BH, S,
hd)`` and the log gates ``(BH, S)``, all float32, and returns the hidden
states ``(BH, S, hd)`` before the output gate; with ``return_state`` also
the state ``(C (BH, hd, hd), n (BH, hd), m (BH,))`` after the last step,
which :func:`repro_torch.models.ssm.mlstm_block` hands to decoding.

Every shape the wrapper takes (hd a multiple of 16, 1 <= chunk <= 256, S a
multiple of the chunk, BH >= 1) goes to the one kernel, which runs its
products on Hopper's tensor cores with each float32 operand split into two
bf16 terms: four grids per call on the current stream (gates, bf16
planes, gated scores, the chunk walk), counted as one ``mlstm_chunk``
launch.  The wrapper allocates the kernel's scratch (bf16 planes padded to
64-row and 64-column tiles: ~0.65 GB at the prefill's (16, 2048, 1024),
L 256).  The kernel has no backward: the wrapper raises on inputs that
require grad.  :func:`repro_torch.kernels.ops.mlstm_chunk` routes to it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import mlstm_chunk_plain, mlstm_chunk_ref  # noqa: F401 (the plain versions)

STEM = "mlstm_chunk_sm90"
# the kernel stages one chunk's gates in shared memory and holds a chunk's
# rows in two warpgroups of 128
MAX_CHUNK = 256

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def scratch_bytes(BH: int, S: int, hd: int, chunk: int) -> int:
    """Bytes of device scratch one call at these sizes allocates."""
    fn = _build.kernel_function(STEM, "mlstm_chunk_sm90_scratch_bytes",
                                [ctypes.c_int] * 4, ctypes.c_longlong)
    return int(fn(BH, S, hd, chunk))


def mlstm_chunk_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_f: torch.Tensor, log_i: torch.Tensor, *, chunk: int,
                     return_state: bool = False):
    """Launch the chunkwise mLSTM kernel on the current stream (no
    synchronize).  Raises on CPU tensors, a dtype other than float32,
    strided or misaligned inputs, inputs that require grad, ``S`` not a
    multiple of ``chunk``, ``chunk`` outside [1, 256] and a head dim that
    is not a multiple of 16."""
    if q.dim() != 3:
        raise ValueError(f"mlstm_chunk: q must be (BH, S, hd), got shape "
                         f"{tuple(q.shape)}")
    BH, S, hd = q.shape
    chunk = int(chunk)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"mlstm_chunk: chunk {chunk} is outside [1, "
                         f"{MAX_CHUNK}]")
    if S % chunk:
        raise ValueError(f"mlstm_chunk: S={S} is not a multiple of "
                         f"chunk={chunk}")
    if hd % 16:
        raise ValueError(f"mlstm_chunk: head dim {hd} is not a multiple of 16")
    device = q.device
    _build.check_cuda_inputs("mlstm_chunk", device, q=(q, (BH, S, hd)),
                             k=(k, (BH, S, hd)), v=(v, (BH, S, hd)),
                             log_f=(log_f, (BH, S)), log_i=(log_i, (BH, S)))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"mlstm_chunk: {name} is not 16-byte aligned")
    f32 = dict(dtype=torch.float32, device=device)
    h = torch.empty((BH, S, hd), **f32)
    C = torch.empty((BH, hd, hd), **f32)
    n = torch.empty((BH, hd), **f32)
    m = torch.empty((BH,), **f32)
    if BH * S == 0:
        C.zero_(), n.zero_(), m.zero_()
    else:
        scratch = torch.empty(scratch_bytes(BH, S, hd, chunk),
                              dtype=torch.uint8, device=device)
        fn = _build.kernel_function(STEM, "mlstm_chunk_sm90", _ARGTYPES)
        _build.launch("mlstm_chunk", STEM, fn, device,
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      log_f.data_ptr(), log_i.data_ptr(), h.data_ptr(),
                      C.data_ptr(), n.data_ptr(), m.data_ptr(),
                      scratch.data_ptr(), BH, S, hd, chunk)
    return (h, (C, n, m)) if return_state else h
