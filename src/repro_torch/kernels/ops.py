"""The router between each CUDA kernel and its plain PyTorch version.

A tensor on the CPU goes to the plain version (counted as ``<name>_ref``),
and so does one on the meta device, which has shapes and no values (the
launch tooling's dry runs); any other tensor goes to the CUDA kernel,
which launches (counted as ``<name>`` in ``_build.launch``) or raises.
There is no fallback from a failed build or launch to the plain version.

Under a :class:`repro_torch.counting.OpCounter` each entry reports one
launch of its kernel with the least work of :mod:`repro_torch.kernels.
work` and hides the ops beneath it, on either route.

``DISPATCH_COUNTS`` keeps the JAX package's key names, so the port states
the same contracts: one ``vgm_decode_table`` dispatch per request, one
``segment_activations`` per generator forward, one
``segment_activations_bwd`` per generator backward on the card, one
``weighted_agg`` per merge tier.  The JAX package counts no flash
attention call; the port counts ``flash_attention_fwd``,
``flash_attention_dq`` and ``flash_attention_dkv`` launches (and
``flash_attention_ref`` plain calls on the CPU) so that a run shows the
kernels ran; likewise ``mlstm_chunk`` (``mlstm_chunk_ref`` on the CPU),
one per mLSTM layer of a prefill.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F

from .. import counting
from . import ref, work
from ._build import DISPATCH_COUNTS
from .flash_attention import FlashAttention
from .mlstm_chunk import mlstm_chunk_cuda
from .segment_activations import (SegmentActivations, build_span_layout,
                                  layout_tensors, segment_activations_cuda)
from .vgm_decode import vgm_decode_table_cuda
from .vgm_encode import vgm_encode_cuda, vgm_encode_table_cuda
from .weighted_agg import weighted_agg_cuda

__all__ = ["DISPATCH_COUNTS", "dispatch_scope", "stage_dispatches",
           "vgm_encode", "vgm_encode_table", "vgm_decode_table",
           "segment_activations", "pack_segments", "weighted_average_flat",
           "weighted_average_edges", "flash_attention", "mlstm_chunk"]


@contextlib.contextmanager
def dispatch_scope():
    """Attribute kernel dispatches to one code region without resetting
    the global counter: the yielded ``Counter`` is filled on exit with the
    region's deltas.

        with ops.dispatch_scope() as d:
            plan.decode(encoded)
        assert stage_dispatches(d, "vgm_decode_table") == 1
    """
    before = DISPATCH_COUNTS.copy()
    scoped: collections.Counter = collections.Counter()
    try:
        yield scoped
    finally:
        for k, v in DISPATCH_COUNTS.items():
            delta = v - before.get(k, 0)
            if delta:
                scoped[k] = delta


def stage_dispatches(counts, stage: str) -> int:
    """Dispatches of one pipeline stage summed over both routes
    (``<stage>`` kernel + ``<stage>_ref`` plain version)."""
    return sum(v for k, v in counts.items()
               if k == stage or k == stage + "_ref")


def _plain_route(t: torch.Tensor) -> bool:
    """The plain route: a tensor on the CPU or without values (meta)."""
    return t.device.type in ("cpu", "meta")


def vgm_encode(x, means, stds, log_weights, gumbel):
    """Encode one continuous column: x (N,), its (K,) mode params and
    (N, K) Gumbel noise -> (alpha (N,), beta (N, K)); see
    :mod:`repro_torch.kernels.vgm_encode`."""
    with counting.kernel("vgm_encode", lambda: work.vgm_encode(
            x.shape[0], 1, gumbel.shape[1]), torch.float32):
        if _plain_route(x):
            DISPATCH_COUNTS["vgm_encode_ref"] += 1
            return ref.vgm_encode_ref(x, means, stds, log_weights, gumbel)
        return vgm_encode_cuda(x, means, stds, log_weights, gumbel)


def vgm_encode_table(x_cols, means, stds, log_weights, gumbel):
    """Encode all continuous columns in one dispatch; see
    :mod:`repro_torch.kernels.vgm_encode`."""
    with counting.kernel("vgm_encode_table", lambda: work.vgm_encode(
            *x_cols.shape, means.shape[1]), torch.float32):
        if _plain_route(x_cols):
            DISPATCH_COUNTS["vgm_encode_table_ref"] += 1
            return ref.vgm_encode_table_ref(x_cols, means, stds,
                                            log_weights, gumbel)
        return vgm_encode_table_cuda(x_cols, means, stds, log_weights,
                                     gumbel)


def vgm_decode_table(slots, means, stds):
    """Decode all continuous columns in one dispatch; see
    :mod:`repro_torch.kernels.vgm_decode`."""
    with counting.kernel("vgm_decode_table", lambda: work.vgm_decode_table(
            slots.shape[0], *means.shape), torch.float32):
        if _plain_route(slots):
            DISPATCH_COUNTS["vgm_decode_table_ref"] += 1
            return ref.vgm_decode_table_ref(slots, means, stds)
        return vgm_decode_table_cuda(slots, means, stds)


def pack_segments(logits: torch.Tensor, spans: Sequence, uniforms: torch.Tensor):
    """Gather a (N, dim) logit row and its (N, dim) uniforms into the
    packed ``(N, S*Wmax)`` lane layout.

    ``uniforms`` lies in the encoded row layout: span ``i`` reads its
    ``(N, w_i)`` draw at ``[start_i, start_i + w_i)``, exactly the
    per-span ``jax.random.uniform(keys[i], (N, w_i))`` streams of the JAX
    reference laid side by side.  Padded lanes and tanh spans get 0.5, and
    padded logit lanes ``-inf``.  Returns (layout, packed_x, packed_u)."""
    layout = build_span_layout(tuple(spans))
    t = layout_tensors(layout, logits.device)
    packed_x = torch.where(t.pack_pad, -torch.inf,
                           logits.float().index_select(1, t.pack_src))
    packed_u = torch.where(t.u_fixed, 0.5,
                           uniforms.float().index_select(1, t.pack_src))
    return layout, packed_x, packed_u


def segment_activations(logits: torch.Tensor, spans: Sequence,
                        uniforms: torch.Tensor, tau: float,
                        hard: bool = False) -> torch.Tensor:
    """tanh + Gumbel-softmax over the whole encoded row in one dispatch.
    ``uniforms`` (N, dim) as in :func:`pack_segments`.

    Differentiable w.r.t. ``logits``, with the soft sample's gradient in
    hard mode too (straight-through): on the CPU by autograd through the
    plain version, on the card through :class:`SegmentActivations`, whose
    backward is one ``segment_activations_bwd`` launch.  A forward that
    needs no gradient launches the forward kernel alone."""
    layout, packed_x, packed_u = pack_segments(logits, spans, uniforms)
    t = layout_tensors(layout, logits.device)
    args = (packed_x, packed_u, t.kinds, float(tau), bool(hard))
    fwd = ("segment_activations", lambda: work.segment_activations(
        packed_x.shape[0], *layout.kinds.shape), torch.float32)
    if _plain_route(logits):
        DISPATCH_COUNTS["segment_activations_ref"] += 1
        out = counting.plain_with_backward(
            ref.segment_activations_ref, args, fwd,
            ("segment_activations_bwd", lambda: work.segment_activations(
                packed_x.shape[0], *layout.kinds.shape, backward=True),
             torch.float32))
    else:
        with counting.kernel(*fwd):
            out = (SegmentActivations.apply(*args) if packed_x.requires_grad
                   else segment_activations_cuda(*args))
    return out.index_select(1, t.unpack_src)


def weighted_average_flat(stacked: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """The federator merge: stacked (P, D) client vectors and (P,) weights
    (normalized inside) -> (D,), in one dispatch counted as
    ``weighted_agg`` (``weighted_agg_ref`` on the CPU)."""
    with counting.kernel("weighted_agg", lambda: work.weighted_agg(
            1, *stacked.shape), torch.float32):
        if _plain_route(stacked):
            DISPATCH_COUNTS["weighted_agg_ref"] += 1
            return ref.weighted_agg_ref(stacked, weights)
        return weighted_agg_cuda(stacked[None], weights[None])[0]


def weighted_average_edges(stacked: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """The edge tier of the hierarchical merge: (E, C, D) per-edge client
    stacks and (E, C) weights -> (E, D), every edge in ONE dispatch, counted
    once as ``weighted_agg`` (``weighted_agg_ref`` on the CPU).  An edge
    whose weights are all 0 merges to zeros."""
    with counting.kernel("weighted_agg", lambda: work.weighted_agg(
            *stacked.shape), torch.float32):
        if _plain_route(stacked):
            DISPATCH_COUNTS["weighted_agg_ref"] += 1
            return ref.weighted_agg_edges_ref(stacked, weights)
        return weighted_agg_cuda(stacked, weights)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q (B, H, Sq, hd); k, v (B, Kh, Sk, hd) with H % Kh == 0 -> (B, H,
    Sq, hd) in q's dtype.  Differentiable: :class:`repro_torch.kernels.
    flash_attention.FlashAttention`, the CUDA kernels on the card and
    their plain versions on the CPU.

    As the reference does outside its custom VJP: KV head h // (H // Kh)
    serves query head h (``repeat_interleave``, outside the autograd
    function, so dk/dv sum over the group through autograd), Sq and Sk are
    padded to multiples of ``block_q`` and ``block_k`` (the padded keys
    masked by the unpadded length), and the output is sliced back."""
    B, H, Sq, hd = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    if H % Kh:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {Kh} KV heads")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} must be >= 1")
    if Kh != H:
        k = torch.repeat_interleave(k, H // Kh, dim=1)
        v = torch.repeat_interleave(v, H // Kh, dim=1)
    pad_q, pad_k = (-Sq) % block_q, (-Sk) % block_k
    if pad_q:
        q = F.pad(q, (0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, pad_k))
    out = FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal, window, Sk)
    return out[:, :, :Sq, :]


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_f: torch.Tensor, log_i: torch.Tensor, *, chunk: int,
                return_state: bool = False):
    """Chunkwise mLSTM hidden states (BH, S, hd), float32, before the
    output gate; q (pre-scaled), k, v (BH, S, hd), log_f, log_i (BH, S).
    With ``return_state`` also ``(C, n, m)`` after the last step.

    CPU tensors take :func:`repro_torch.kernels.ref.mlstm_chunk_plain`
    (differentiable by autograd), counted as ``mlstm_chunk_ref``; CUDA
    tensors launch the kernel (:mod:`repro_torch.kernels.mlstm_chunk`),
    counted as ``mlstm_chunk``.  The kernel has no backward, as the
    reference's Pallas kernel has none: on the card, inputs that require
    grad under autograd raise ``NotImplementedError``."""
    args = (q, k, v, log_f, log_i)
    if not _plain_route(q) and torch.is_grad_enabled() and any(
            t.requires_grad for t in args):
        raise NotImplementedError(
            "mlstm_chunk: the CUDA kernel has no backward; see ROADMAP queue "
            "1, \"xLSTM training on the card\". Run the forward under "
            "torch.no_grad()")
    # no backward kernel: under autograd the plain version's backward ops
    # are counted as they run
    with counting.kernel("mlstm_chunk", lambda: work.mlstm_chunk(
            *q.shape, chunk), torch.float32):
        if _plain_route(q):
            DISPATCH_COUNTS["mlstm_chunk_ref"] += 1
            return ref.mlstm_chunk_plain(*args, chunk=chunk,
                                         return_state=return_state)
        return mlstm_chunk_cuda(*args, chunk=chunk, return_state=return_state)
