"""Seeded numpy inputs for the port's kernel tests, kept away from argmax
ties so that every discrete output must match exactly (``decode_inputs``
makes mode ties on request)."""
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


# (N, Q, Kmax, live modes per column) of the table encode's card tests
ENCODE_CASES = [
    (40_000, 22, 10, [10] * 22),         # intrusion at the paper's rows
    (8000, 5, 10, [10, 10, 7, 3, 10]),   # one training client of adult
    (4099, 5, 10, [10, 10, 7, 3, 10]),   # N not a multiple of a tile
    (1000, 22, 10, [10] * 22),
    (129, 3, 7, [7, 2, 5]),              # ragged tiles, odd Kmax
    (777, 6, 1, [1] * 6),                # Kmax 1
    (1, 1, 1, [1]),
    (37, 96, 32, [32, 17] * 48),         # Q * Kmax = 3,072
]
# (N, K, live modes) of the single-column encode's card tests
COLUMN_CASES = [
    (40_000, 10, 10), (8000, 10, 10), (4099, 10, 7), (129, 7, 7),
    (1000, 1, 1), (1, 1, 1), (33, 3072, 3072),
]

# (N, Q, Kmax, live modes per column) of the table decode's card tests
DECODE_CASES = [
    (4099, 5, 10, [10, 10, 7, 3, 10]),   # N not a multiple of a block
    (3, 1, 1, [1]),
    (4096, 22, 10, [10] * 22),           # the serving shape
    (1, 1, 1, [1]),                      # N 1, Kmax 1
    (1001, 22, 10, [10, 9, 3] * 7 + [1]),
    (777, 7, 3, [3, 2, 1, 3, 3, 1, 2]),  # an even slot width, 1 + Kmax
    (64, 30, 60, [60, 31] * 15),         # wide slots
    (5, 1, 1500, [1500]),                # one very wide slot
]


def decode_inputs(seed, N, Q, K, ks, ties=False):
    """Slots for ``ks[q]`` live modes per column; ``ties``: the betas are
    whole multiples of 0.5, so modes tie and the first maximum must win."""
    rng = np.random.default_rng(seed)
    live = np.arange(K)[None, :] < np.asarray(ks)[:, None]
    means = np.where(live, rng.normal(size=(Q, K)) * 10.0, 0.0)
    stds = np.where(live, 0.5 + rng.random((Q, K)) * 4.0, 1.0)
    slots = rng.normal(size=(N, Q, 1 + K))
    if ties:
        slots[:, :, 1:] = np.round(slots[:, :, 1:] * 2.0) / 2.0
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
    # the forward's tile at 24 and 32 lanes, where its stage passes the
    # default 48 KB of shared memory
    "w24": spans_of([(1, "tanh"), (24, "softmax"), (5, "softmax")]),
    "w32": spans_of([(1, "tanh"), (32, "softmax"), (9, "softmax")]),
    # Wmax past one warp's lanes: 40 (the forward's tile, up to 44 lanes)
    # and 300 (its warp layout, ten strides of 32 lanes)
    "mid": spans_of([(1, "tanh"), (40, "softmax"), (7, "softmax")]),
    "wide": spans_of([(1, "tanh"), (300, "softmax"), (7, "softmax")]),
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


# Flash-attention shapes the card tests hold the kernels to, and the CPU
# test of the bf16 tensor-core kernels' precision design emulates:
# B, H, S, hd, causal, window, kv_len.  Every query row sees some key: a
# row that sees none (a padded row past kv_len, further than the window)
# averages every key in the plain versions' -1e30 mask, and no kernel
# tile that would hold those keys is visited.
FLASH_CASES = [
    (2, 3, 256, 64, True, None, 256),
    (1, 2, 256, 32, False, None, 256),
    (1, 2, 384, 128, True, None, 384),
    (1, 2, 256, 64, True, 48, 256),
    (2, 2, 256, 64, False, 100, 200),     # padded keys past kv_len
    (2, 9, 2048, 64, True, None, 2048),   # the LM path's shape
    (1, 2, 1000, 128, True, None, 1000),  # ragged: a tile crosses S
    (1, 3, 640, 32, True, 160, 500),      # a window and padded keys
]
