"""Seeded numpy inputs for the port's kernel tests, kept away from argmax
ties so that every discrete output must match exactly."""
import numpy as np
import torch

from repro_torch.kernels.segment_activations import build_span_layout
from repro_torch.tabular.encoders import SpanInfo

NEG_INF = -1e30


def encode_inputs(seed, N, Q, K, ks):
    """Packed (Q, K) params with ks[q] live modes and Gumbels nudged so the
    winning mode leads the runner-up by at least 1e-2 (no near ties)."""
    rng = np.random.default_rng(seed)
    live = np.arange(K)[None, :] < np.asarray(ks)[:, None]
    means = np.where(live, rng.normal(size=(Q, K)) * 3.0, 0.0)
    stds = np.where(live, 0.5 + rng.random((Q, K)), 1.0)
    logw = np.where(live, rng.normal(size=(Q, K)) * 0.3, NEG_INF)
    x = rng.normal(size=(N, Q)) * 2.0
    g = rng.gumbel(size=(N, Q, K))
    z = (x[:, :, None] - means[None]) / stds[None]
    score = -0.5 * z * z - np.log(stds)[None] + logw[None] + g
    if K > 1:
        top = np.sort(score, axis=2)
        nudge = np.clip(1e-2 - (top[:, :, -1] - top[:, :, -2]), 0.0, None)
        g[np.arange(N)[:, None], np.arange(Q)[None, :], score.argmax(2)] += nudge
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (f32(x), f32(means), f32(stds), f32(logw),
            f32(g.reshape(N, Q * K)))


def as_tensors(*arrays):
    """Contiguous tensors, as the kernels require."""
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def decode_inputs(seed, N, Q, K, ks):
    rng = np.random.default_rng(seed)
    live = np.arange(K)[None, :] < np.asarray(ks)[:, None]
    means = np.where(live, rng.normal(size=(Q, K)) * 10.0, 0.0)
    stds = np.where(live, 0.5 + rng.random((Q, K)) * 4.0, 1.0)
    slots = rng.normal(size=(N, Q, 1 + K))
    slots[:, :, 0] *= 1.5                     # some alphas outside [-1, 1]
    slots[:, :, 1:] = np.where(live[None], slots[:, :, 1:], NEG_INF)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(slots.reshape(N, Q * (1 + K))), f32(means), f32(stds)


def spans_of(widths_kinds):
    spans, pos = [], 0
    for j, (w, kind) in enumerate(widths_kinds):
        spans.append(SpanInfo(pos, w, kind, j, kind == "softmax"))
        pos += w
    return tuple(spans)


def activation_inputs(seed, N, spans, tau):
    """Packed logits/uniforms for ``spans``; the leading lane of each
    softmax span is nudged 0.05 ahead in scaled-logit space (no ties)."""
    rng = np.random.default_rng(seed)
    layout = build_span_layout(spans)
    dim = layout.dim
    logits = rng.normal(size=(N, dim)) * 2.0
    u = rng.uniform(0.01, 0.99, size=(N, dim))
    g = -np.log(-np.log(u))
    for s in spans:
        if s.activation == "tanh" or s.width == 1:
            continue
        sl = slice(s.start, s.start + s.width)
        zz = (logits[:, sl] + g[:, sl]) / tau
        top = np.sort(zz, axis=1)
        nudge = np.clip(0.05 - (top[:, -1] - top[:, -2]), 0.0, None) * tau
        logits[np.arange(N), s.start + zz.argmax(1)] += nudge
    pad = layout.pack_pad
    tanh = np.repeat(layout.kinds[:, 0] > 0.5, layout.wmax)
    px = np.where(pad[None], -np.inf, logits[:, layout.pack_src])
    pu = np.where((pad | tanh)[None], 0.5, u[:, layout.pack_src])
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(px), f32(pu), layout


ACT_LAYOUTS = {
    "ctgan": spans_of([(1, "tanh"), (10, "softmax"), (1, "tanh"),
                     (10, "softmax"), (7, "softmax"), (2, "softmax")]),
    "width1": spans_of([(1, "softmax"), (1, "tanh"), (3, "softmax")]),
    "one_span": spans_of([(18, "softmax")]),
}


def mlstm_inputs(seed, BH, S, hd, log_f=None):
    """The chunkwise mLSTM's inputs as the reference's kernel tests draw
    them (``tests/test_kernels.py``): q ~ N(0, 1) / sqrt(hd) (pre-scaled),
    k, v ~ N(0, 1), log_f = log_sigmoid(2 + N(0, 1)) (or the constant
    ``log_f``), log_i ~ 0.5 N(0, 1); float32 arrays."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(BH, S, hd)) / np.sqrt(hd)
    k = rng.normal(size=(BH, S, hd))
    v = rng.normal(size=(BH, S, hd))
    lf = -np.logaddexp(0.0, -(2.0 + rng.normal(size=(BH, S))))
    if log_f is not None:
        lf = np.full((BH, S), log_f)
    li = 0.5 * rng.normal(size=(BH, S))
    return tuple(np.asarray(a, np.float32) for a in (q, k, v, lf, li))
