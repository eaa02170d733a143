"""The port's three kernels held against the JAX package on the same inputs.

Each kernel's plain PyTorch version (the CPU route of
``repro_torch.kernels.ops``) is compared with the Pallas kernel run in
interpret mode and with its ``repro.kernels.ref`` oracle.  Inputs come
from numpy with fixed seeds and are kept away from argmax ties, so every
discrete output (mode argmax, beta one-hot, hard one-hot) must be equal.

Tolerances on floats:
  * encode alpha: rtol 1e-6, atol 1e-6 -- one division and a clip in
    float32 on both sides; only rounding of the log-pdf differs.
  * decode: rtol 1e-6, atol 1e-6 -- XLA may contract ``a*4*sd + mu`` into
    a fused multiply-add, the port never does: one rounding of the result.
  * activations: atol 2e-6 on values in [-1, 1] -- XLA's and PyTorch's
    vectorized log/exp/tanh differ by an ulp or two, and 1/tau = 5
    amplifies the error of the scaled logits before the exp.

The CUDA wrappers need a card: on a CPU tensor they raise.  Their tests
against the plain versions are in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.segment_activations import \
    segment_activations as pallas_segment_activations  # noqa: E402
from repro.kernels.vgm_decode import \
    vgm_decode_table as pallas_vgm_decode  # noqa: E402
from repro.kernels.vgm_encode import \
    vgm_encode_table as pallas_vgm_encode  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.segment_activations import (  # noqa: E402
    build_span_layout, segment_activations_bwd_cuda, segment_activations_cuda)
from repro_torch.kernels.vgm_decode import vgm_decode_table_cuda  # noqa: E402
from repro_torch.kernels.vgm_encode import vgm_encode_table_cuda  # noqa: E402
from repro_torch.kernels.weighted_agg import weighted_agg_cuda  # noqa: E402
from repro_torch.tabular.encoders import SpanInfo  # noqa: E402
from torch_kernel_inputs import (ACT_LAYOUTS, activation_inputs,  # noqa: E402
                                 as_tensors, decode_inputs, encode_inputs)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.mark.parametrize("N,Q,K,ks,block_n", [
    (512, 4, 10, [10, 9, 8, 10], 256),
    (777, 3, 8, [8, 2, 5], 256),        # N not a multiple of the block
    (300, 1, 10, [10], 128),            # one column
    (5, 2, 3, [1, 3], 4),               # a one-mode column, tiny N
])
def test_vgm_encode_table_plain_matches_pallas_and_ref(N, Q, K, ks, block_n):
    inputs = encode_inputs(N + Q, N, Q, K, ks)
    pallas = np.asarray(pallas_vgm_encode(*map(jnp.asarray, inputs),
                                          block_n=block_n, interpret=True))
    oracle = np.asarray(jref.vgm_encode_table_ref(*map(jnp.asarray, inputs)))
    port = tref.vgm_encode_table_ref(*as_tensors(*inputs)).numpy()
    assert port.shape == (N, Q * (1 + K))
    for other in (pallas, oracle):
        s = port.reshape(N, Q, 1 + K)
        o = other.reshape(N, Q, 1 + K)
        np.testing.assert_array_equal(s[:, :, 1:], o[:, :, 1:])
        np.testing.assert_allclose(s[:, :, 0], o[:, :, 0], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("N,Q,K,ks,block_n", [
    (512, 4, 10, [10, 7, 10, 3], 256),
    (777, 3, 8, [8, 1, 5], 256),        # N not a multiple of the block
    (64, 1, 10, [10], 64),              # one column
])
def test_vgm_decode_table_plain_matches_pallas_and_ref(N, Q, K, ks, block_n):
    inputs = decode_inputs(N * Q, N, Q, K, ks)
    pallas = np.asarray(pallas_vgm_decode(*map(jnp.asarray, inputs),
                                          block_n=block_n, interpret=True))
    oracle = np.asarray(jax.jit(jref.vgm_decode_table_ref)(
        *map(jnp.asarray, inputs)))
    port = tref.vgm_decode_table_ref(*as_tensors(*inputs)).numpy()
    assert port.shape == (N, Q)
    np.testing.assert_allclose(port, pallas, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port, oracle, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("N,layout,block_n", [
    (256, "ctgan", 128),
    (777, "ctgan", 256),                # N not a multiple of the block
    (33, "width1", 16),                 # spans of width 1
    (64, "one_span", 64),
])
def test_segment_activations_plain_matches_pallas_and_ref(N, layout, block_n,
                                                          hard):
    tau = 0.2
    px, pu, lay = activation_inputs(N, N, ACT_LAYOUTS[layout], tau)
    kinds = lay.kinds
    pallas = np.asarray(pallas_segment_activations(
        jnp.asarray(px), jnp.asarray(pu), jnp.asarray(kinds), tau=tau,
        hard=hard, block_n=block_n, interpret=True))
    oracle = np.asarray(jref.segment_activations_ref(
        jnp.asarray(px), jnp.asarray(pu), jnp.asarray(kinds), tau, hard))
    port = tref.segment_activations_ref(*as_tensors(px, pu, kinds), tau, hard).numpy()
    live = ~lay.pack_pad
    for other in (pallas, oracle):
        np.testing.assert_allclose(port[:, live], other[:, live], rtol=0,
                                   atol=2e-6)
        if hard:
            soft_live = live & (np.repeat(kinds[:, 0], lay.wmax) < 0.5)
            np.testing.assert_array_equal(np.rint(port[:, soft_live]),
                                          np.rint(other[:, soft_live]))


def test_ops_routes_cpu_tensors_to_the_plain_versions():
    enc_in = as_tensors(*encode_inputs(0, 16, 2, 4, [4, 2]))
    dec_in = as_tensors(*decode_inputs(0, 16, 2, 4, [4, 2]))
    spans = ACT_LAYOUTS["ctgan"]
    logits = torch.randn(8, build_span_layout(spans).dim)
    with ops.dispatch_scope() as d:
        a = ops.vgm_encode_table(*enc_in)
        b = ops.vgm_decode_table(*dec_in)
        ops.segment_activations(logits, spans, torch.rand(logits.shape),
                                0.2, hard=True)
    assert dict(d) == {"vgm_encode_table_ref": 1, "vgm_decode_table_ref": 1,
                       "segment_activations_ref": 1}
    assert ops.stage_dispatches(d, "vgm_decode_table") == 1
    torch.testing.assert_close(a, tref.vgm_encode_table_ref(*enc_in),
                               rtol=0, atol=0)
    torch.testing.assert_close(b, tref.vgm_decode_table_ref(*dec_in),
                               rtol=0, atol=0)


def test_ops_segment_activations_matches_reference_wrapper():
    """The uniform packing: per-span ``jax.random.uniform(keys[i], (N,
    w_i))`` draws laid side by side in the encoded layout give the JAX
    wrapper's values (tanh spans and padding pinned to 0.5)."""
    spans = ACT_LAYOUTS["ctgan"]
    N, tau = 64, 0.2
    dim = build_span_layout(spans).dim
    logits = np.random.default_rng(5).normal(size=(N, dim)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    keys = jax.random.split(key, len(spans))
    uniforms = np.full((N, dim), 0.5, np.float32)
    for s, k in zip(spans, keys):
        if s.activation != "tanh":
            uniforms[:, s.start:s.start + s.width] = np.asarray(
                jax.random.uniform(k, (N, s.width), jnp.float32))
    from repro.kernels import ops as jops
    for hard in (False, True):
        expect = np.asarray(jops.segment_activations(
            jnp.asarray(logits), spans, key, tau, hard=hard,
            use_pallas=False))
        port = ops.segment_activations(torch.from_numpy(logits), spans,
                                       torch.from_numpy(uniforms), tau,
                                       hard=hard).numpy()
        np.testing.assert_allclose(port, expect, rtol=0, atol=2e-6)


def test_span_layout_matches_reference():
    from repro.kernels.segment_activations import \
        build_span_layout as jax_layout
    from repro.tabular.encoders import SpanInfo as JaxSpanInfo
    spans = ACT_LAYOUTS["ctgan"]
    mine = build_span_layout(spans)
    theirs = jax_layout(tuple(JaxSpanInfo(*map(
        lambda f: getattr(s, f), ("start", "width", "activation", "column",
                                  "is_condition"))) for s in spans))
    assert (mine.wmax, mine.dim) == (theirs.wmax, theirs.dim)
    for f in ("pack_src", "pack_pad", "unpack_src", "kinds"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(theirs, f))
    with pytest.raises(ValueError, match="contiguously"):
        build_span_layout((SpanInfo(1, 2, "softmax", 0, True),))


@pytest.mark.parametrize("call", ["encode", "decode", "activations",
                                  "activations_bwd", "weighted_agg"])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """A CUDA wrapper handed a CPU tensor raises before building anything:
    the plain route is chosen by the router, never by the wrapper."""
    calls = {
        "activations_bwd": lambda: segment_activations_bwd_cuda(
            torch.zeros(4, 6), torch.full((4, 6), 0.5), torch.zeros(2, 3),
            torch.ones(4, 6), 0.2),
        "weighted_agg": lambda: weighted_agg_cuda(torch.ones(1, 3, 8),
                                                  torch.ones(1, 3)),
        "encode": lambda: vgm_encode_table_cuda(
            *as_tensors(*encode_inputs(0, 8, 2, 4, [4, 4]))),
        "decode": lambda: vgm_decode_table_cuda(
            *as_tensors(*decode_inputs(0, 8, 2, 4, [4, 4]))),
        "activations": lambda: segment_activations_cuda(
            torch.zeros(4, 6), torch.full((4, 6), 0.5), torch.zeros(2, 3),
            0.2),
    }
    before = dict(_build.DISPATCH_COUNTS)
    with pytest.raises(ValueError, match="CUDA tensors"):
        calls[call]()
    assert dict(_build.DISPATCH_COUNTS) == before
