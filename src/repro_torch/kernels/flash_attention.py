"""Flash attention: the CUDA kernels (forward, backward dq, backward dk/dv),
their plain PyTorch versions and the ``autograd.Function`` that joins them.

Each entry picks its library by the inputs' dtype: bfloat16, the LM path's
type, launches the tensor-core kernels of ``csrc/flash_attention_sm90.cu``
(``wgmma`` fed by TMA, P and dS split into bf16 terms for the second
products); float32 launches the CUDA-core kernels of
``csrc/flash_attention.cu``.  Both libraries export the same three C
entries, each instantiated at head dims 32, 64, 80 (hubert-xlarge's) and
128.

:class:`FlashAttention` works on padded, head-matched ``(B, H, S, hd)``
inputs, as the reference's custom VJP does
(``src/repro/kernels/flash_attention.py:243``): its forward saves q, k,
v, out and lse; its backward computes ``delta = sum(do * out, -1)`` in
float32, casts ``do`` to q's dtype, takes dq and dk/dv in float32 and
casts each to its input's dtype.  Tensors on the CPU take the plain
versions (each call counted as ``flash_attention_ref``); CUDA tensors
launch the kernels (counted as ``flash_attention_fwd``,
``flash_attention_dq`` and ``flash_attention_dkv``) or raise; meta
tensors, which have no values, take the plain versions too.
:func:`repro_torch.kernels.ops.flash_attention` adds the GQA expansion
and the padding around it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import counting
from . import _build, ref, work
from ._build import DISPATCH_COUNTS

# head dims and element types the kernels are instantiated for, and the
# library (csrc/<stem>.cu) of each element type
HEAD_DIMS = (32, 64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_STEMS = {torch.float32: "flash_attention",
          torch.bfloat16: "flash_attention_sm90"}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SHAPE = [_I] * 6 + [_F, _I, _I, _P]       # bh sq sk kv_len causal window
                                           # scale hd bf16 stream
_FWD_ARGS = [_P] * 5 + _SHAPE
_DQ_ARGS = [_P] * 7 + _SHAPE
_DKV_ARGS = [_P] * 8 + _SHAPE


def _check(name: str, q, k, v, do=None, lse=None, delta=None
           ) -> tuple[int, int, int, int]:
    """Raise unless q, k, v (and ``do``) are contiguous CUDA tensors of one
    float32 or bfloat16 dtype with a head dim the kernels take, lse and
    delta (B, H, Sq) float32, and, for bfloat16, every one starts on a
    16-byte boundary.  Returns (B*H, Sq, Sk, hd)."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} is not one of {HEAD_DIMS}")
    same = {"q": (q, (B, H, Sq, hd)), "k": (k, (B, H, Sk, hd)),
            "v": (v, (B, H, Sk, hd))}
    if do is not None:
        same["do"] = (do, (B, H, Sq, hd))
    _build.check_cuda_inputs(name, q.device, dtype=q.dtype, **same)
    if lse is not None:
        _build.check_cuda_inputs(name, q.device, lse=(lse, (B, H, Sq)),
                                 delta=(delta, (B, H, Sq)))
        same.update(lse=(lse, None), delta=(delta, None))
    if q.dtype == torch.bfloat16:   # the tensor-core kernels read by TMA
        for arg, (t, _) in same.items():
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: {arg} must start on a 16-byte "
                                 "boundary")
    return B * H, Sq, Sk, hd


def library_stem(dtype: torch.dtype) -> str:
    """The CUDA source whose kernels take inputs of ``dtype``."""
    return _STEMS[dtype]


def _shape_args(bh, sq, sk, hd, dtype, causal, window, kv_len):
    return (bh, sq, sk, int(kv_len), int(bool(causal)),
            0 if window is None else int(window), 1.0 / math.sqrt(hd), hd,
            _DTYPES[dtype])


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window: int | None, kv_len: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """q, k, v (B, H, S, hd) contiguous float32 or bfloat16 on the card ->
    out (B, H, Sq, hd) in q's dtype and lse (B, H, Sq) float32: launch the
    forward kernel on the current stream (no synchronize)."""
    bh, sq, sk, hd = _check("flash_attention_fwd", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if bh * sq == 0:
        return out, lse
    stem = library_stem(q.dtype)
    fn = _build.kernel_function(stem, "flash_attention_fwd", _FWD_ARGS)
    _build.launch("flash_attention_fwd", stem, fn, q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr(),
                  *_shape_args(bh, sq, sk, hd, q.dtype, causal, window, kv_len))
    return out, lse


def flash_dq_cuda(q, k, v, do, lse, delta, *, causal: bool,
                  window: int | None, kv_len: int) -> torch.Tensor:
    """dq (B, H, Sq, hd) float32 from the backward dq kernel; ``do`` in
    q's dtype, ``lse`` and ``delta`` (B, H, Sq) float32."""
    bh, sq, sk, hd = _check("flash_attention_dq", q, k, v, do, lse, delta)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if bh * sq == 0:
        return dq
    stem = library_stem(q.dtype)
    fn = _build.kernel_function(stem, "flash_attention_dq", _DQ_ARGS)
    _build.launch("flash_attention_dq", stem, fn, q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                  *_shape_args(bh, sq, sk, hd, q.dtype, causal, window, kv_len))
    return dq


def flash_dkv_cuda(q, k, v, do, lse, delta, *, causal: bool,
                   window: int | None, kv_len: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) (B, H, Sk, hd) float32 from the backward dk/dv kernel."""
    bh, sq, sk, hd = _check("flash_attention_dkv", q, k, v, do, lse, delta)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    if bh * sk == 0:
        return dk, dv
    stem = library_stem(q.dtype)
    fn = _build.kernel_function(stem, "flash_attention_dkv", _DKV_ARGS)
    _build.launch("flash_attention_dkv", stem, fn, q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(),
                  *_shape_args(bh, sq, sk, hd, q.dtype, causal, window, kv_len))
    return dk, dv


def _plain(q) -> bool:
    """The plain route: inputs on the CPU or without values (meta)."""
    return q.device.type in ("cpu", "meta")


def _work(kind: str, q, mask) -> tuple:
    """The counter's record of one launch: (name, work, dtype), as
    :func:`repro_torch.counting.kernel` takes it."""
    def least():
        B, H, Sq, hd = q.shape
        return work.flash_attention(kind, B * H, Sq, hd, q.dtype, **mask)
    return f"flash_attention_{kind}", least, q.dtype


def _forward(q, k, v, mask):
    with counting.kernel(*_work("fwd", q, mask)):
        if _plain(q):
            DISPATCH_COUNTS["flash_attention_ref"] += 1
            return ref.flash_attention_fwd_ref(q, k, v, **mask)
        return flash_fwd_cuda(q, k, v, **mask)


def _backward(q, k, v, do, lse, delta, mask):
    args = (q, k, v, do, lse, delta)
    with counting.kernel(*_work("dq", q, mask)):
        if _plain(q):
            DISPATCH_COUNTS["flash_attention_ref"] += 1
            dq = ref.flash_attention_dq_ref(*args, **mask)
        else:
            dq = flash_dq_cuda(*args, **mask)
    with counting.kernel(*_work("dkv", q, mask)):
        if _plain(q):
            DISPATCH_COUNTS["flash_attention_ref"] += 1
            dk, dv = ref.flash_attention_dkv_ref(*args, **mask)
        else:
            dk, dv = flash_dkv_cuda(*args, **mask)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention over padded, head-matched q, k, v (B, H, S, hd),
    differentiable w.r.t. all three.  ``kv_len`` is the unpadded key
    count.  The kernels get detached tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int | None, kv_len: int):
        q, k, v = q.detach(), k.detach(), v.detach()
        mask = {"causal": bool(causal), "window": window,
                "kv_len": int(kv_len)}
        out, lse = _forward(q, k, v, mask)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = mask
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        delta = torch.sum(do.float() * out.float(), dim=-1)
        dq, dk, dv = _backward(q, k, v, do.to(q.dtype).contiguous(), lse,
                               delta, ctx.mask)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)
