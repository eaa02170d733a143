"""Per-span generator-head activations: the CUDA kernels
``csrc/segment_activations.cu`` (forward and backward), their plain
PyTorch versions, the autograd function that joins the two kernels, and
the ``(S, Wmax)`` span packing all of them work on.

The generator's output row is a patchwork of spans: a tanh over each VGM
alpha and a Gumbel-softmax (temperature ``tau``, straight-through one-hot
when ``hard``) over each mode or category span.  :class:`SpanLayout`
packs the row into ``S`` slots of ``Wmax`` lanes; padded logit lanes hold
``-inf`` so they take no softmax mass and never win the argmax.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .. import counting
from . import _build, work
from .ref import (segment_activations_bwd_ref,  # noqa: F401 (plain versions)
                  segment_activations_ref)


@dataclasses.dataclass(frozen=True, eq=False)
class SpanLayout:
    """Static packing of an encoded-row span list into ``(S, Wmax)``.

    ``pack_src``/``pack_pad`` gather the (B, dim) row into the padded
    (B, S*Wmax) lane layout (padded lanes read position 0 and are then
    masked); ``unpack_src`` is the inverse gather: spans tile the row
    contiguously in order, so the p-th live lane is encoded position p.
    ``kinds`` carries 1.0 rows for tanh spans.
    """
    spans: tuple
    wmax: int
    dim: int
    pack_src: np.ndarray       # (S*Wmax,) int64
    pack_pad: np.ndarray       # (S*Wmax,) bool
    unpack_src: np.ndarray     # (dim,) int64
    kinds: np.ndarray          # (S, Wmax) float32


@functools.lru_cache(maxsize=None)
def build_span_layout(spans: tuple) -> SpanLayout:
    """Build (once per span tuple) the packed activation layout."""
    S = len(spans)
    wmax = max(s.width for s in spans)
    pack_src = np.zeros(S * wmax, np.int64)
    pack_pad = np.ones(S * wmax, bool)
    kinds = np.zeros((S, wmax), np.float32)
    dim = 0
    for i, s in enumerate(spans):
        if s.start != dim:
            raise ValueError("spans must tile the encoded row contiguously")
        base = i * wmax
        pack_src[base:base + s.width] = s.start + np.arange(s.width)
        pack_pad[base:base + s.width] = False
        if s.activation == "tanh":
            kinds[i] = 1.0
        dim += s.width
    unpack_src = np.flatnonzero(~pack_pad)
    return SpanLayout(spans=spans, wmax=wmax, dim=dim, pack_src=pack_src,
                      pack_pad=pack_pad, unpack_src=unpack_src, kinds=kinds)


@dataclasses.dataclass(frozen=True)
class LayoutTensors:
    """A :class:`SpanLayout`'s gathers and masks as tensors on one device.
    ``u_fixed`` marks the lanes whose uniform is pinned to 0.5: padded
    lanes and every lane of a tanh span."""
    pack_src: torch.Tensor
    pack_pad: torch.Tensor
    u_fixed: torch.Tensor
    unpack_src: torch.Tensor
    kinds: torch.Tensor


@functools.lru_cache(maxsize=None)
def layout_tensors(layout: SpanLayout, device: torch.device) -> LayoutTensors:
    """Upload (once per layout and device) the layout's index tensors."""
    tanh_lane = np.repeat(layout.kinds[:, 0] > 0.5, layout.wmax)
    return LayoutTensors(
        pack_src=torch.as_tensor(layout.pack_src, device=device),
        pack_pad=torch.as_tensor(layout.pack_pad, device=device),
        u_fixed=torch.as_tensor(layout.pack_pad | tanh_lane, device=device),
        unpack_src=torch.as_tensor(layout.unpack_src, device=device),
        kinds=torch.as_tensor(layout.kinds, device=device))


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_float,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
# the forward's layouts: "auto" picks by Wmax; the others force one (tests,
# and the layout sweep of chip_smoke.py)
FORWARD_LAYOUTS = {"auto": 0, "tile": 1, "warp": 2, "warp_unstaged": 3}


def segment_activations_cuda(packed_x: torch.Tensor, packed_u: torch.Tensor,
                             kinds: torch.Tensor, tau: float,
                             hard: bool = False, *,
                             layout: str = "auto") -> torch.Tensor:
    """Launch the forward activation kernel on the current stream (no
    synchronize).  Records no autograd graph: raises on inputs that require
    grad rather than drop their gradient (:class:`SegmentActivations` is
    the differentiable route).  Each row of ``kinds`` must be uniform (all
    1.0 or all 0.0), as :func:`build_span_layout` makes it.  ``layout``
    names one of :data:`FORWARD_LAYOUTS` (``csrc/segment_activations.cu``
    describes them); a forced layout whose stage does not fit the card's
    shared memory raises."""
    N = packed_x.shape[0]
    S, W = kinds.shape
    device = packed_x.device
    _build.check_cuda_inputs(
        "segment_activations", device, packed_x=(packed_x, (N, S * W)),
        packed_u=(packed_u, (N, S * W)), kinds=(kinds, (S, W)))
    out = torch.empty((N, S * W), dtype=torch.float32, device=device)
    if N * S * W == 0:
        return out
    fn = _build.kernel_function("segment_activations",
                                "segment_activations_f32", _ARGTYPES)
    _build.launch("segment_activations", "segment_activations", fn, device,
                  packed_x.data_ptr(), packed_u.data_ptr(), kinds.data_ptr(),
                  out.data_ptr(), N, S, W, float(tau), int(bool(hard)),
                  FORWARD_LAYOUTS[layout])
    return out


_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_float,
                                         ctypes.c_void_p]
# the backward's layouts past 32 lanes ("auto" stages where it fits, and
# up to 32 lanes all take the groups): forced in tests and in the layout
# line of chip_smoke.py
BACKWARD_LAYOUTS = {"auto": 0, "groups": 1, "groups_unstaged": 2}


def segment_activations_bwd_cuda(packed_x: torch.Tensor,
                                 packed_u: torch.Tensor, kinds: torch.Tensor,
                                 ct: torch.Tensor, tau: float, *,
                                 layout: str = "auto") -> torch.Tensor:
    """Launch the backward kernel on the current stream (no synchronize):
    the gradient w.r.t. ``packed_x`` for the upstream gradient ``ct``, the
    soft sample's in hard mode too (straight-through), so it takes no
    ``hard``.  ``layout`` names one of :data:`BACKWARD_LAYOUTS`
    (``csrc/segment_activations.cu`` describes them)."""
    N = packed_x.shape[0]
    S, W = kinds.shape
    device = packed_x.device
    _build.check_cuda_inputs(
        "segment_activations_bwd", device, packed_x=(packed_x, (N, S * W)),
        packed_u=(packed_u, (N, S * W)), kinds=(kinds, (S, W)),
        ct=(ct, (N, S * W)))
    grad = torch.empty((N, S * W), dtype=torch.float32, device=device)
    if N * S * W == 0:
        return grad
    args = (packed_x.data_ptr(), packed_u.data_ptr(), kinds.data_ptr(),
            ct.data_ptr(), grad.data_ptr(), N, S, W, float(tau))
    if layout == "auto":
        fn = _build.kernel_function("segment_activations",
                                    "segment_activations_bwd_f32",
                                    _BWD_ARGTYPES)
    else:
        fn = _build.kernel_function(
            "segment_activations", "segment_activations_bwd_layout_f32",
            _BWD_ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p])
        args += (BACKWARD_LAYOUTS[layout],)
    _build.launch("segment_activations_bwd", "segment_activations", fn,
                  device, *args)
    return grad


class SegmentActivations(torch.autograd.Function):
    """The packed activations on the card, differentiable w.r.t. the
    logits: the forward kernel, and the backward kernel for the gradient.
    ``packed_u`` and ``kinds`` take no gradient.  The kernels get detached
    tensors; only the logits, uniforms and kinds are saved."""

    @staticmethod
    def forward(ctx, packed_x, packed_u, kinds, tau, hard):
        x, u = packed_x.detach(), packed_u.detach()
        ctx.save_for_backward(x, u, kinds)
        ctx.tau = float(tau)
        return segment_activations_cuda(x, u, kinds, tau, hard)

    @staticmethod
    def backward(ctx, ct):
        x, u, kinds = ctx.saved_tensors
        with counting.kernel("segment_activations_bwd",
                             lambda: work.segment_activations(
                                 x.shape[0], *kinds.shape, backward=True),
                             torch.float32):
            grad = segment_activations_bwd_cuda(x, u, kinds, ct.contiguous(),
                                                ctx.tau)
        return grad, None, None, None, None
