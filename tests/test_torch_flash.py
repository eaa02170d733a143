"""The port's flash attention held against the JAX package's on the CPU.

The same numpy-seeded q, k, v and upstream gradients go through JAX's
``flash_attention`` (its Pallas kernels in interpret mode, gradients by
``jax.grad`` through its custom VJP) and the port's
``ops.flash_attention`` (its ``autograd.Function`` with the plain
forward, dq and dk/dv on the CPU).  On the card the same function
launches the CUDA kernels; ``tests/test_torch_cuda.py`` holds those
against these plain versions.

Tolerances: float32 outputs and lse rtol 1e-5, atol 1e-5, gradients
rtol 1e-4, atol 1e-5 -- the same float32 arithmetic, but the Pallas
kernel sums its online softmax tile by tile (128 keys at a time) and the
plain version over the whole row, so sums round in another order.
bfloat16 outputs: both round a float32 result to bfloat16 once, and may
land one bfloat16 ulp apart where they straddle a rounding boundary: rtol
2^-7; their gradients are rounded to bfloat16 too: rtol 2^-7 and atol one
bfloat16 ulp of the largest gradient.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jflash  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

CASES = {  # B, H, Kh, Sq, Sk, hd, causal, window
    "gqa_causal": (1, 4, 2, 128, 128, 32, True, None),
    "ragged_100": (1, 3, 3, 100, 100, 32, True, None),
    "ragged_200_gqa_bidirectional": (2, 2, 1, 200, 200, 64, False, None),
    "window": (1, 2, 2, 256, 256, 32, True, 64),
    "hd64_mqa": (1, 3, 1, 128, 128, 64, True, None),
}


def _inputs(seed, B, H, Kh, Sq, Sk, hd):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, Sq, hd)).astype(np.float32)
    k = rng.normal(size=(B, Kh, Sk, hd)).astype(np.float32)
    v = rng.normal(size=(B, Kh, Sk, hd)).astype(np.float32)
    ct = rng.normal(size=(B, H, Sq, hd)).astype(np.float32)
    return q, k, v, ct


def _to_jax(arrays, dtype):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _to_torch(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.detach().float().numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(name):
    B, H, Kh, Sq, Sk, hd, causal, window = CASES[name]
    q, k, v, _ = _inputs(1, B, H, Kh, Sq, Sk, hd)
    want = jflash.flash_attention(*_to_jax((q, k, v), jnp.float32),
                                  causal=causal, window=window,
                                  interpret=True)
    before = ops.DISPATCH_COUNTS["flash_attention_ref"]
    got = ops.flash_attention(*_to_torch((q, k, v), torch.float32),
                              causal=causal, window=window)
    assert ops.DISPATCH_COUNTS["flash_attention_ref"] == before + 1
    assert got.shape == (B, H, Sq, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["ragged_100", "window"])
def test_lse_matches_jax_forward(name):
    """The saved log-sum-exp over padded, head-matched inputs (the padded
    keys masked by the unpadded length), against the Pallas forward's."""
    B, H, Kh, Sq, Sk, hd, causal, window = CASES[name]
    q, k, v, _ = _inputs(2, B, H, Kh, Sq, Sk, hd)
    k, v = (np.repeat(a, H // Kh, axis=1) for a in (k, v))
    pad = (-Sq) % 128
    q, k, v = (np.pad(a, ((0, 0), (0, 0), (0, pad), (0, 0))) for a in (q, k, v))
    j_out, j_lse = jflash._fwd_call(
        *_to_jax((q, k, v), jnp.float32), causal=causal, window=window,
        block_q=128, block_k=128, kv_len=Sk, interpret=True)
    t_out, t_lse = ref.flash_attention_fwd_ref(
        *_to_torch((q, k, v), torch.float32), causal=causal, window=window,
        kv_len=Sk)
    np.testing.assert_allclose(_f32(t_lse), _f32(j_lse), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_f32(t_out), _f32(j_out), rtol=1e-5, atol=1e-5)


def _grads(name, dtype_j, dtype_t, seed=3):
    B, H, Kh, Sq, Sk, hd, causal, window = CASES[name]
    q, k, v, ct = _inputs(seed, B, H, Kh, Sq, Sk, hd)
    jq, jk, jv = _to_jax((q, k, v), dtype_j)
    jct = jnp.asarray(ct).astype(dtype_j)

    def loss(q, k, v):
        out = jflash.flash_attention(q, k, v, causal=causal, window=window,
                                     interpret=True)
        return jnp.sum((out * jct).astype(jnp.float32))
    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)

    leaves = [t.requires_grad_() for t in _to_torch((q, k, v), dtype_t)]
    out = ops.flash_attention(*leaves, causal=causal, window=window)
    torch.sum((out * torch.from_numpy(ct).to(dtype_t)).float()).backward()
    return [t.grad for t in leaves], want


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_jax(name):
    """dq, dk, dv through the autograd function (dk/dv summed over each
    GQA group by the expansion's own backward) against jax.grad through
    the Pallas custom VJP."""
    before = ops.DISPATCH_COUNTS["flash_attention_ref"]
    got, want = _grads(name, jnp.float32, torch.float32)
    assert ops.DISPATCH_COUNTS["flash_attention_ref"] == before + 3
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["gqa_causal", "ragged_100"])
def test_bfloat16_matches_jax(name):
    B, H, Kh, Sq, Sk, hd, causal, window = CASES[name]
    q, k, v, _ = _inputs(4, B, H, Kh, Sq, Sk, hd)
    want = jflash.flash_attention(*_to_jax((q, k, v), jnp.bfloat16),
                                  causal=causal, window=window,
                                  interpret=True)
    got = ops.flash_attention(*_to_torch((q, k, v), torch.bfloat16),
                              causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2 ** -7,
                               atol=1e-6)
    g_got, g_want = _grads(name, jnp.bfloat16, torch.bfloat16, seed=5)
    for g, w in zip(g_got, g_want):
        assert g.dtype == torch.bfloat16
        w = _f32(w)
        np.testing.assert_allclose(_f32(g), w, rtol=2 ** -7,
                                   atol=2 ** -8 * float(np.abs(w).max()))


def test_plain_attention_matches_jax_reference():
    """``ref.attention_ref``, the full-matrix oracle, against the JAX
    package's, with a GQA group of 3 (interleaved heads)."""
    from repro.kernels import ref as jref
    q, k, v, _ = _inputs(6, 2, 6, 2, 64, 64, 32)
    for causal, window in ((True, None), (False, 16)):
        want = jref.attention_ref(*_to_jax((q, k, v), jnp.float32),
                                  causal=causal, window=window)
        got = ref.attention_ref(*_to_torch((q, k, v), torch.float32),
                                causal=causal, window=window)
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5,
                                   atol=1e-5)


def test_gqa_expansion_interleaves_heads():
    """Query head h reads KV head h // g: a KV head of zeros silences
    exactly its group of query heads."""
    q, k, v, _ = _inputs(7, 1, 6, 2, 32, 32, 32)
    v[:, 1] = 0.0
    out = ops.flash_attention(*_to_torch((q, k, v), torch.float32))
    assert out[:, 3:].abs().max() == 0
    assert out[:, :3].abs().max() > 0


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers take CUDA tensors only: on the CPU they raise
    before building anything (the plain versions are the CPU route)."""
    q = torch.zeros((1, 1, 64, 64))
    mask = {"causal": True, "window": None, "kv_len": 64}
    with pytest.raises(ValueError, match="CUDA tensors"):
        tflash.flash_fwd_cuda(q, q, q, **mask)
    lse = torch.zeros((1, 1, 64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tflash.flash_dq_cuda(q, q, q, q, lse, lse, **mask)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tflash.flash_dkv_cuda(q, q, q, q, lse, lse, **mask)


def test_flash_attention_refuses_bad_shapes():
    q = torch.zeros((1, 4, 8, 32))
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, torch.zeros((1, 3, 8, 32)),
                            torch.zeros((1, 3, 8, 32)))
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, window=0)


def test_sm_scale_is_float32_reciprocal_sqrt():
    """The kernels get 1/sqrt(hd) as a C float, the value the Pallas body
    multiplies by in float32."""
    args = tflash._shape_args(2, 128, 128, 32, torch.float32, True, None, 100)
    assert args[:6] == (2, 128, 128, 100, 1, 0)
    assert np.float32(args[6]) == np.float32(1.0 / math.sqrt(32))
