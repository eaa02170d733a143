"""``repro_torch.tabular.encode_column`` held against the JAX package's
``repro.tabular.encode_column`` on the same column, mixture and draws.

The reference draws the mode with ``jax.random.categorical(key, logits)``,
which is ``argmax(jax.random.gumbel(key, logits.shape) + logits)``; the
port is handed those Gumbels.  The one-hot ``beta`` must be equal.
``alpha`` must agree within 1e-7 absolute: the same float32 divisions and
clips, one ulp near 1 for a different fusion in XLA.  The cases are a
mixture fitted by the reference on a bimodal column, a hand-built mixture
whose pruned mode sits on some rows (the reference gives a pruned mode
the log-weight log(1e-12), not the kernels' -1e30, so it can be drawn:
the case asserts that the reference draws it), and a single mode.  On the
CPU the port's route is ``vgm_encode``'s plain version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.tabular import vgm as jvgm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.tabular import encode_column  # noqa: E402
from repro_torch.tabular.vgm import VGMParams  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ALPHA_ATOL = 1e-7
PRUNED_ROWS = 20


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fitted(rng):
    x = np.concatenate([rng.normal(-3.0, 0.5, 180),
                        rng.normal(4.0, 1.0, 120)]).astype(np.float32)
    return x, jvgm.fit_vgm(jnp.asarray(x), jax.random.PRNGKey(0),
                           max_modes=10)


def _pruned(rng):
    """Two valid modes at 0 and 10 and a pruned one at 80, with rows at 80
    that lie far from both valid modes."""
    x = np.concatenate([rng.normal(0.0, 1.0, 60), rng.normal(10.0, 1.0, 40),
                        np.full(PRUNED_ROWS, 80.0)]).astype(np.float32)
    params = jvgm.VGMParams(
        weights=jnp.asarray([0.6, 0.4, 1e-4], jnp.float32),
        means=jnp.asarray([0.0, 10.0, 80.0], jnp.float32),
        stds=jnp.asarray([1.0, 1.0, 2.0], jnp.float32),
        valid=jnp.asarray([True, True, False]))
    return x, params


def _one_mode(rng):
    x = rng.normal(2.0, 3.0, 150).astype(np.float32)
    return x, jvgm.fit_vgm(jnp.asarray(x), jax.random.PRNGKey(1),
                           max_modes=1)


CASES = {"fitted": _fitted, "pruned_mode_drawn": _pruned,
         "one_mode": _one_mode}


def _to_torch(p) -> VGMParams:
    return VGMParams(*(torch.from_numpy(np.array(a)) for a in
                       (p.weights, p.means, p.stds, p.valid)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_encode_column_matches_reference(case):
    x, jparams = CASES[case](np.random.default_rng(5))
    key = jax.random.PRNGKey(11)
    j_alpha, j_beta = jvgm.encode_column(jnp.asarray(x), jparams, key)
    K = int(jparams.means.shape[0])
    g = jax.random.gumbel(key, (x.shape[0], K), jnp.float32)

    before = ops.DISPATCH_COUNTS["vgm_encode_ref"]
    alpha, beta = encode_column(torch.from_numpy(x), _to_torch(jparams),
                                gumbel=torch.from_numpy(np.array(g)))
    assert ops.DISPATCH_COUNTS["vgm_encode_ref"] == before + 1

    assert alpha.shape == (x.shape[0],) and beta.shape == (x.shape[0], K)
    assert beta.dtype == torch.float32
    np.testing.assert_array_equal(beta.numpy(), np.asarray(j_beta))
    np.testing.assert_allclose(alpha.numpy(), np.asarray(j_alpha),
                               rtol=0, atol=ALPHA_ATOL)
    if case == "pruned_mode_drawn":
        # the reference draws the pruned mode for every row at 80: the
        # log(1e-12) convention, which -1e30 would not reproduce
        assert not bool(jparams.valid[2])
        assert (np.asarray(j_beta)[-PRUNED_ROWS:, 2] == 1).all()


def test_encode_column_generator_is_reproducible():
    x, jparams = _fitted(np.random.default_rng(6))
    params = _to_torch(jparams)
    xt = torch.from_numpy(x)
    runs = [encode_column(xt, params,
                          generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][1].sum(dim=1), torch.ones(x.shape[0]))
    other = encode_column(xt, params,
                          generator=torch.Generator().manual_seed(4))
    assert not torch.equal(other[1], runs[0][1])
