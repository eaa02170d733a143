"""The chunkwise mLSTM: the CUDA kernels ``csrc/mlstm_chunk_sm90.cu`` (the
forward) and ``csrc/mlstm_chunk_bwd.cu`` (its backward), and their plain
PyTorch versions.

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
L 256).

``mlstm_chunk_bwd_cuda`` takes the same inputs and the gradient ``dh`` of
h and returns ``(dq, dk, dv, dlog_f, dlog_i)``: eleven grids on the
current stream, counted as one ``mlstm_chunk_bwd`` launch, whose products
run on the tensor cores as the forward's do (two bf16 terms per operand,
three for the raw scores q k^T).  Its scratch holds the bf16 planes of
every operand (padded to 128-row and 128-column tiles), the chunk-start
states and their gradients as planes, and the float32 partial sums: ~0.47
GB at the training shape's (16, 512, 1024), L 256, ~2.3 GB at the
prefill's (16, 2048, 1024).  Both wrappers take detached tensors;
:class:`repro_torch.kernels.ops.MLSTMChunk` joins them under autograd.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import (mlstm_chunk_bwd_plain, mlstm_chunk_plain,  # noqa: F401
                  mlstm_chunk_ref)                 # (the plain versions)

STEM = "mlstm_chunk_sm90"
STEM_BWD = "mlstm_chunk_bwd"
# the kernel stages one chunk's gates in shared memory and holds a chunk's
# rows in two warpgroups of 128
MAX_CHUNK = 256

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def scratch_bytes(BH: int, S: int, hd: int, chunk: int, *,
                  backward: bool = False) -> int:
    """Bytes of device scratch one call (of the backward with
    ``backward``) at these sizes allocates."""
    stem = STEM_BWD if backward else STEM
    fn = _build.kernel_function(stem, f"{stem}_scratch_bytes",
                                [ctypes.c_int] * 4, ctypes.c_longlong)
    return int(fn(BH, S, hd, chunk))


def _check(name: str, q, k, v, log_f, log_i, chunk: int, **more):
    """Raise unless the inputs are what the kernels take; returns (BH, S,
    hd)."""
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be (BH, S, hd), got shape "
                         f"{tuple(q.shape)}")
    BH, S, hd = q.shape
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"{name}: chunk {chunk} is outside [1, "
                         f"{MAX_CHUNK}]")
    if S % chunk:
        raise ValueError(f"{name}: S={S} is not a multiple of "
                         f"chunk={chunk}")
    if hd % 16:
        raise ValueError(f"{name}: head dim {hd} is not a multiple of 16")
    rows = {k_: (t, (BH, S, hd)) for k_, t in more.items()}
    _build.check_cuda_inputs(name, q.device, q=(q, (BH, S, hd)),
                             k=(k, (BH, S, hd)), v=(v, (BH, S, hd)),
                             log_f=(log_f, (BH, S)), log_i=(log_i, (BH, S)),
                             **rows)
    for arg, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} is not 16-byte aligned")
    return BH, S, hd


def mlstm_chunk_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_f: torch.Tensor, log_i: torch.Tensor, *, chunk: int,
                     return_state: bool = False):
    """Launch the chunkwise mLSTM kernel on the current stream (no
    synchronize).  Raises on CPU tensors, a dtype other than float32,
    strided or misaligned inputs, inputs that require grad, ``S`` not a
    multiple of ``chunk``, ``chunk`` outside [1, 256] and a head dim that
    is not a multiple of 16."""
    chunk = int(chunk)
    BH, S, hd = _check("mlstm_chunk", q, k, v, log_f, log_i, chunk)
    device = q.device
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


def mlstm_chunk_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         log_f: torch.Tensor, log_i: torch.Tensor,
                         dh: torch.Tensor, *, chunk: int):
    """Launch the chunkwise mLSTM backward kernel on the current stream (no
    synchronize): the gradient of h for ``dh`` (BH, S, hd), ``(dq, dk, dv,
    dlog_f, dlog_i)`` float32, as :func:`mlstm_chunk_bwd_plain` computes
    it.  Raises as :func:`mlstm_chunk_cuda` does, and on a ``dh`` that is
    not a float32 (BH, S, hd) CUDA tensor."""
    chunk = int(chunk)
    BH, S, hd = _check("mlstm_chunk_bwd", q, k, v, log_f, log_i, chunk,
                       dh=dh)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty((BH, S, hd), **f32) for _ in range(3))
    dlf, dli = torch.empty((BH, S), **f32), torch.empty((BH, S), **f32)
    if BH * S:
        scratch = torch.empty(scratch_bytes(BH, S, hd, chunk, backward=True),
                              dtype=torch.uint8, device=q.device)
        fn = _build.kernel_function(STEM_BWD, "mlstm_chunk_bwd",
                                    _BWD_ARGTYPES)
        _build.launch("mlstm_chunk_bwd", STEM_BWD, fn, q.device,
                      *(t.data_ptr() for t in (q, k, v, log_f, log_i, dh, dq,
                                               dk, dv, dlf, dli, scratch)),
                      BH, S, hd, chunk)
    return dq, dk, dv, dlf, dli
