"""The CUDA activation backward's arithmetic emulated on the CPU (no card
needed), and the plain table decode that the card's decode kernel must
equal at its test shapes, held against the JAX reference.

``csrc/segment_activations.cu`` computes the backward with a group of G
threads per (row, span) (G the least power of two >= Wmax, at most 32),
each thread holding one lane, and a warp per span past 32 lanes, each
thread summing its lanes t, t + 32, ... in order: the span's max, its sum
of exponentials and the dot with ct are then ``__shfl_xor_sync`` trees
over the group.  :func:`backward_emulation` repeats that order in float32
and is held against ``jax.grad`` through the reference's
``segment_activations_packed`` at every layout the card tests use, within
the card's atol 3e-5 (``tests/test_torch_cuda.py`` gives the reason).

``tests/test_torch_cuda.py`` holds ``csrc/vgm_decode.cu`` to the plain
version exactly at ``DECODE_CASES``; here the plain version meets the JAX
reference's oracle at the same shapes, with mode ties too (the first
maximum wins on both sides): rtol 1e-6, atol 1e-6, since XLA may contract
``a * 4 * sd + mu`` into one fused multiply-add.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.segment_activations import (  # noqa: E402
    segment_activations_packed)
from repro_torch.kernels import ref as tref  # noqa: E402
from torch_kernel_inputs import (ACT_LAYOUTS, DECODE_CASES,  # noqa: E402
                                 activation_inputs, decode_inputs)

GUMBEL_EPS = np.float32(1e-20)


def _tree(a: torch.Tensor, op) -> torch.Tensor:
    """The value every lane holds after ``v = op(v, shfl_xor(v, off))`` for
    off = G/2, ..., 1 over the last axis (G lanes, a power of two)."""
    while a.shape[-1] > 1:
        h = a.shape[-1] // 2
        a = op(a[..., :h], a[..., h:])
    return a[..., 0]


def _lanes_then_tree(v: torch.Tensor, g: int, op, neutral: float):
    """(N, S, W) -> (N, S): each of g threads folds its lanes t, t + g, ...
    in order from ``neutral`` (one lane each where g >= W: the fold is
    exact), then the group's shuffle tree (none for g = 1)."""
    N, S, W = v.shape
    r = -(-W // g)
    pad = torch.full((N, S, r * g - W), neutral, dtype=v.dtype)
    per = torch.cat([v, pad], dim=2).reshape(N, S, r, g)
    acc = torch.full((N, S, g), neutral, dtype=v.dtype)
    for j in range(r):
        acc = op(acc, per[:, :, j])
    return _tree(acc, op)


def backward_emulation(px, pu, kinds, ct, tau):
    """The backward kernel's float32 arithmetic in its order (a group of G
    threads a span, past 32 lanes a warp whose threads fold their lanes
    first), on the CPU."""
    N = px.shape[0]
    S, W = kinds.shape
    threads = min(32, 1 << (W - 1).bit_length())
    x, u, c = (t.reshape(N, S, W) for t in (px, pu, ct))
    pad = x == -np.inf
    soft = (kinds[None] < 0.5) & ~pad
    gum = -torch.log(-torch.log(u + GUMBEL_EPS) + GUMBEL_EPS)
    z = torch.where(soft, (x + gum) / tau, -np.inf)
    m = _lanes_then_tree(z, threads, torch.maximum, -np.inf)
    e = torch.where(soft, torch.exp(z - m[..., None]), 0.0)
    total = _lanes_then_tree(e, threads, torch.add, 0.0)
    y = torch.where(soft, e / total[..., None], 0.0)
    dot = _lanes_then_tree(c * y, threads, torch.add, 0.0)
    th = torch.tanh(x)
    grad = torch.where(soft, y * (c - dot[..., None]) / tau, 0.0)
    grad = torch.where((kinds[None] > 0.5) & ~pad, c * (1.0 - th * th), grad)
    return grad.reshape(N, S * W)


def _jax_grad(px, pu, kinds, ct, tau, hard):
    def loss(x):
        return jnp.sum(segment_activations_packed(
            x, jnp.asarray(pu), jnp.asarray(kinds), tau, hard, False, False,
            128) * jnp.asarray(ct))
    return np.asarray(jax.grad(loss)(jnp.asarray(px)))


@pytest.mark.parametrize("tau", [0.2, 1.0])
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("layout", sorted(ACT_LAYOUTS))
def test_backward_order_matches_jax_grad(layout, hard, tau):
    """The training temperature (0.2) and CTGAN's default (1.0)."""
    px, pu, lay = activation_inputs(11, 257, ACT_LAYOUTS[layout], tau)
    rng = np.random.default_rng(12)
    ct = rng.uniform(-1, 1, size=px.shape).astype(np.float32)
    want = _jax_grad(px, pu, lay.kinds, ct, tau, hard)
    args = [torch.from_numpy(a) for a in (px, pu, lay.kinds, ct)]
    got = backward_emulation(*args, tau).numpy()
    live = ~lay.pack_pad
    assert np.abs(want[:, live]).max() > 0.1
    np.testing.assert_allclose(got[:, live], want[:, live], rtol=0, atol=3e-5)
    assert not got[:, lay.pack_pad].any()          # padded lanes: exactly 0
    plain = tref.segment_activations_bwd_ref(*args, tau, hard)
    np.testing.assert_allclose(got, plain.numpy(), rtol=0, atol=3e-5)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("N,Q,K,ks", DECODE_CASES)
def test_decode_card_cases_plain_matches_jax(N, Q, K, ks, ties):
    slots, means, stds = decode_inputs(3, N, Q, K, ks, ties=ties)
    port = tref.vgm_decode_table_ref(torch.from_numpy(slots),
                                     torch.from_numpy(means),
                                     torch.from_numpy(stds)).numpy()
    oracle = np.asarray(jax.jit(jref.vgm_decode_table_ref)(
        jnp.asarray(slots), jnp.asarray(means), jnp.asarray(stds)))
    assert port.shape == (N, Q)
    np.testing.assert_allclose(port, oracle, rtol=1e-6, atol=1e-6)
