"""The port's xLSTM blocks and its chunkwise mLSTM held against the JAX
package on the CPU, with float32 parameters carried across and
numpy-seeded inputs, at the reference's own test sizes
(``tests/test_kernels.py``, ``tests/test_ssm_blocks.py``).  The reference's
Pallas ``mlstm_chunk`` runs in interpret mode; the port's CPU route is its
plain version ``mlstm_chunk_plain``.

Tolerances:
  * the chunkwise plain version against the reference's Pallas kernel and
    its per-step oracle: rtol 2e-3, atol 2e-4, the reference's own
    kernel-vs-oracle tolerance (``tests/test_kernels.py``): the chunkwise
    and per-step forms take their stabilizers at other steps, so their
    float32 roundings differ by more than a summation order.  The state
    after the last step is held tighter, rtol 1e-4 and atol 1e-5: each
    form rescales it once per chunk or step by a factor at most 1.
  * the port's blocks, decode steps and states against the reference's
    same functions: rtol 1e-5, atol 1e-5 -- the same formulas in float32,
    products and sums taken in another order.
  * gradients: rtol 1e-4 and atol 1e-6 times the leaf's largest |gradient|
    (at least 1e-6) -- each entry is a cancelling sum of many terms, which
    rounds at the scale of its largest terms, not of the result.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mlstm_chunk import mlstm_chunk as jmlstm_chunk  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.mlstm_chunk import mlstm_chunk_cuda  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from torch_kernel_inputs import as_tensors, mlstm_inputs  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

TIGHT = dict(rtol=1e-5, atol=1e-5)


def _cfgs(**kw):
    """The reference's ``tests/test_ssm_blocks.py`` config, in both
    packages: d_model 64, 4 heads, mLSTM head dim 32, float32."""
    base = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                d_ff=0, vocab=64, ssm_expand=2, mlstm_chunk=8,
                dtype="float32")
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def _carry(jparams):
    return {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}


def _x(seed, B, S, D, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=(B, S, D))
            ).astype(np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---- the chunkwise plain version ------------------------------------------

@pytest.mark.parametrize("BH,S,hd,chunk,log_f", [
    (2, 64, 32, 16, None), (4, 128, 64, 32, None), (1, 256, 128, 128, None),
    (3, 96, 16, 32, None),
    (1, 32, 16, 16, -30.0),      # strong decay: the state resets every step
])
def test_mlstm_chunk_plain_matches_pallas_and_oracle(BH, S, hd, chunk, log_f):
    arrays = mlstm_inputs(BH * S + hd, BH, S, hd, log_f=log_f)
    got = tref.mlstm_chunk_plain(*as_tensors(*arrays), chunk=chunk)
    pallas = jmlstm_chunk(*map(jnp.asarray, arrays), chunk=chunk,
                          interpret=True)
    oracle = jref.mlstm_chunk_ref(*map(jnp.asarray, arrays))
    np.testing.assert_allclose(_np(got), np.asarray(pallas), rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(_np(got), np.asarray(oracle), rtol=2e-3,
                               atol=2e-4)
    # the port's own per-step oracle is the reference's
    np.testing.assert_allclose(
        _np(tref.mlstm_chunk_ref(*as_tensors(*arrays))), np.asarray(oracle),
        **TIGHT)


def test_mlstm_chunk_plain_state_is_the_recurrence_state():
    """The carry after the last chunk equals the state after the last step
    of the per-step recurrence (the reference's ``mlstm_decode`` update,
    written out in jnp), whatever the chunk size."""
    BH, S, hd = 3, 96, 16
    q, k, v, lf, li = mlstm_inputs(7, BH, S, hd)
    C = jnp.zeros((BH, 1, hd, hd))
    n = jnp.zeros((BH, 1, hd))
    m = jnp.zeros((BH, 1))
    for t in range(S):
        m_new = jnp.maximum(lf[:, t, None] + m, li[:, t, None])
        fg, ig = jnp.exp(lf[:, t, None] + m - m_new), jnp.exp(li[:, t, None] - m_new)
        C = fg[..., None, None] * C + ig[..., None, None] * (
            k[:, t, None, :, None] * v[:, t, None, None, :])
        n = fg[..., None] * n + ig[..., None] * k[:, t, None]
        m = m_new
    for chunk in (16, 32, 96):
        _, (tC, tn, tm) = tref.mlstm_chunk_plain(
            *as_tensors(q, k, v, lf, li), chunk=chunk, return_state=True)
        np.testing.assert_allclose(_np(tm), np.asarray(m[:, 0]), **TIGHT)
        np.testing.assert_allclose(_np(tn), np.asarray(n[:, 0]), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(tC), np.asarray(C[:, 0]), rtol=1e-4,
                                   atol=1e-5)


def test_mlstm_chunk_plain_refuses_a_ragged_chunk():
    args = as_tensors(*mlstm_inputs(0, 1, 24, 16))
    with pytest.raises(ValueError, match="not a multiple"):
        tref.mlstm_chunk_plain(*args, chunk=16)


def test_mlstm_chunk_cuda_refuses_cpu_tensors():
    args = as_tensors(*mlstm_inputs(0, 1, 32, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        mlstm_chunk_cuda(*args, chunk=16)


# ---- mLSTM block, state and decode -----------------------------------------

@pytest.mark.parametrize("S,chunk", [(16, 8), (32, 16), (24, 8), (8, 8)])
def test_mlstm_block_matches_reference(S, chunk):
    jcfg, cfg = _cfgs(mlstm_chunk=chunk)
    jp = jssm.init_mlstm(jax.random.PRNGKey(S), jcfg, jnp.float32)
    x = _x(S, 2, S, jcfg.d_model)
    before = ops.DISPATCH_COUNTS.copy()
    y, st = tssm.mlstm_block(_carry(jp), torch.from_numpy(x), cfg,
                             return_state=True)
    assert ops.DISPATCH_COUNTS["mlstm_chunk_ref"] \
        == before["mlstm_chunk_ref"] + 1
    assert ops.DISPATCH_COUNTS["mlstm_chunk"] == before["mlstm_chunk"]
    jy, jst = jssm.mlstm_block(jp, jnp.asarray(x), jcfg, return_state=True)
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TIGHT)
    for got, want in zip(st, jst, strict=True):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    # the chunkwise path against the per-step oracles of both packages
    np.testing.assert_allclose(_np(y), np.asarray(jssm.mlstm_scan_ref(
        jp, jnp.asarray(x), jcfg)), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(
        _np(tssm.mlstm_scan_ref(_carry(jp), torch.from_numpy(x), cfg)),
        np.asarray(jssm.mlstm_scan_ref(jp, jnp.asarray(x), jcfg)), **TIGHT)


def test_mlstm_block_gradient_matches_reference():
    """The CPU route is differentiable: the gradient of a scalar of the
    block's output w.r.t. its input and parameters, against ``jax.grad``."""
    jcfg, cfg = _cfgs(mlstm_chunk=8)
    jp = jssm.init_mlstm(jax.random.PRNGKey(3), jcfg, jnp.float32)
    x = _x(3, 2, 16, jcfg.d_model)
    ct = _x(4, 2, 16, jcfg.d_model)

    def jloss(p, x):
        return jnp.sum(jssm.mlstm_block(p, x, jcfg) * ct)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: t.requires_grad_() for k, t in _carry(jp).items()}
    tx = torch.from_numpy(x).requires_grad_()
    loss = torch.sum(tssm.mlstm_block(tp, tx, cfg) * torch.from_numpy(ct))
    loss.backward()
    for key, got, want in [("x", tx.grad, jgx)] + [
            (key, tp[key].grad, jgp[key]) for key in jp]:
        want = np.asarray(want)
        np.testing.assert_allclose(
            _np(got), want, rtol=1e-4,
            atol=1e-6 * max(1.0, float(np.abs(want).max())), err_msg=key)


def test_mlstm_decode_matches_reference():
    jcfg, cfg = _cfgs()
    jp = jssm.init_mlstm(jax.random.PRNGKey(1), jcfg, jnp.float32)
    p = _carry(jp)
    x = _x(2, 2, 12, jcfg.d_model)
    jst = jssm.init_mlstm_state(jcfg, 2)
    st = tssm.init_mlstm_state(cfg, 2, device="cpu")
    for t in range(x.shape[1]):
        jy, jst = jssm.mlstm_decode(jp, jnp.asarray(x[:, t:t + 1]), jst, jcfg)
        y, st = tssm.mlstm_decode(p, torch.from_numpy(x[:, t:t + 1]), st, cfg)
        np.testing.assert_allclose(_np(y), np.asarray(jy), **TIGHT)
    for got, want in zip(st, jst, strict=True):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TIGHT)


# ---- sLSTM ----------------------------------------------------------------

def test_slstm_block_and_decode_match_reference():
    jcfg, cfg = _cfgs()
    jp = jssm.init_slstm(jax.random.PRNGKey(2), jcfg, jnp.float32)
    p = _carry(jp)
    x = _x(5, 2, 10, jcfg.d_model)
    y, st = tssm.slstm_block(p, torch.from_numpy(x), cfg, return_state=True)
    jy, jst = jssm.slstm_block(jp, jnp.asarray(x), jcfg, return_state=True)
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TIGHT)
    for got, want in zip(st, jst, strict=True):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TIGHT)
    jst = jssm.init_slstm_state(jcfg, 2)
    st = tssm.init_slstm_state(cfg, 2, device="cpu")
    for t in range(x.shape[1]):
        jy, jst = jssm.slstm_decode(jp, jnp.asarray(x[:, t:t + 1]), jst, jcfg)
        y, st = tssm.slstm_decode(p, torch.from_numpy(x[:, t:t + 1]), st, cfg)
        np.testing.assert_allclose(_np(y), np.asarray(jy), **TIGHT)
    for got, want in zip(st, jst, strict=True):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TIGHT)


def test_slstm_stays_finite_over_a_long_sequence():
    jcfg, cfg = _cfgs()
    p = _carry(jssm.init_slstm(jax.random.PRNGKey(0), jcfg, jnp.float32))
    y = tssm.slstm_block(p, torch.from_numpy(_x(6, 1, 256, 64, 5.0)), cfg)
    assert torch.isfinite(y).all()
