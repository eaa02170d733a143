"""The port's single-column VGM encode and the per-column ``encode_loop``
held against the JAX package on the CPU.

The plain single-column encode gets the same numpy-seeded inputs and
Gumbel noise as ``repro.kernels.ref.vgm_encode_ref`` (kept away from
argmax ties): one-hots must be equal, alphas close (rtol 1e-6, atol
1e-6: float32 rounding of the log-pdf in XLA and PyTorch).  ``encode_loop``
runs from the reference's encoders (carried over) and the reference's own
per-column Gumbel streams: it must equal the port's one-dispatch
``encode`` exactly, and the reference's ``encode_loop`` within the same
tolerance.  The CUDA kernel is held against the plain version on the card
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.vgm_encode import vgm_encode as jvgm_encode  # noqa: E402
from repro.tabular import datasets as jds  # noqa: E402
from repro.tabular import encoders as jenc  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.vgm_encode import vgm_encode_cuda  # noqa: E402
from torch_kernel_inputs import encode_inputs  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def _column(seed, N, K, k):
    x, means, stds, logw, g = encode_inputs(seed, N, 1, K, [k])
    return x[:, 0].copy(), means[0], stds[0], logw[0], g


@pytest.mark.parametrize("N,K,k", [(1000, 10, 10), (513, 10, 4), (7, 1, 1)])
def test_vgm_encode_plain_matches_reference(N, K, k):
    args = _column(1, N, K, k)
    ja, jb = jref.vgm_encode_ref(*(jnp.asarray(a) for a in args))
    with ops.dispatch_scope() as d:
        ta, tb = ops.vgm_encode(*(torch.from_numpy(a) for a in args))
    assert dict(d) == {"vgm_encode_ref": 1}
    assert ta.shape == (N,) and tb.shape == (N, K)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6,
                               atol=1e-6)


def test_vgm_encode_plain_matches_pallas_kernel():
    """Against the Pallas single-column kernel itself, in interpret mode
    (its rows padded to a block of 128)."""
    args = _column(2, 300, 10, 7)
    ja, jb = jvgm_encode(*(jnp.asarray(a) for a in args), block_n=128,
                         interpret=True)
    ta, tb = tref.vgm_encode_ref(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6,
                               atol=1e-6)


def test_vgm_encode_is_the_table_encode_for_one_column():
    """The single-column plain version is the Q = 1 case of the table
    version: alpha and beta are the one slot's lanes, bit for bit."""
    x, means, stds, logw, g = (torch.from_numpy(a) for a in
                               encode_inputs(3, 777, 1, 10, [9]))
    alpha, beta = tref.vgm_encode_ref(x[:, 0], means[0], stds[0], logw[0], g)
    slots = tref.vgm_encode_table_ref(x, means, stds, logw, g)
    assert torch.equal(alpha, slots[:, 0])
    assert torch.equal(beta, slots[:, 1:])


def test_single_column_wrapper_refuses_cpu_tensors():
    args = [torch.from_numpy(a) for a in _column(4, 8, 3, 3)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        vgm_encode_cuda(*args)


@pytest.fixture(scope="module")
def adult():
    """A small adult table, its reference encoders, the same encoders
    carried over to the port (on the CPU), and the reference's packed
    per-column Gumbel draws."""
    ds = jds.make_dataset("adult", n_rows=1024, seed=4)
    key = jax.random.PRNGKey(4)
    ref_enc = jenc.fit_centralized_encoders(ds.data, ds.schema, key)
    vgms = {j: {f: np.asarray(getattr(p, f))
                for f in ("weights", "means", "stds", "valid")}
            for j, p in ref_enc.vgms.items()}
    cats = {j: le.categories for j, le in ref_enc.label_encoders.items()}
    port_enc = interop.encoders_from_reference(ds.schema, vgms, cats,
                                               device="cpu")
    enc_key = jax.random.PRNGKey(5)
    gumbel = np.array(ref_enc.plan()._draw_gumbel(enc_key, ds.n_rows))
    return ds, enc_key, ref_enc, port_enc, torch.from_numpy(gumbel)


def test_encode_loop_equals_encode(adult):
    ds, _, _, port_enc, gumbel = adult
    n_cont = sum(c.kind == "continuous" for c in ds.schema)
    with ops.dispatch_scope() as d:
        looped = port_enc.encode_loop(ds.data, gumbel=gumbel)
    assert dict(d) == {"vgm_encode_ref": n_cont}
    assert torch.equal(looped, port_enc.encode(ds.data, gumbel=gumbel))
    gen = torch.Generator().manual_seed(6)
    drawn = port_enc.encode_loop(ds.data, generator=gen)
    assert torch.equal(drawn, port_enc.encode(
        ds.data, generator=torch.Generator().manual_seed(6)))


def test_encode_loop_matches_reference(adult):
    ds, enc_key, ref_enc, port_enc, gumbel = adult
    expect = np.asarray(ref_enc.encode_loop(ds.data, enc_key))
    ours = port_enc.encode_loop(ds.data, gumbel=gumbel).numpy()
    assert ours.shape == expect.shape
    tanh = np.array([s.start for s in ref_enc.spans()
                     if s.activation == "tanh"])
    onehot = np.setdiff1d(np.arange(expect.shape[1]), tanh)
    np.testing.assert_array_equal(ours[:, onehot], expect[:, onehot])
    np.testing.assert_allclose(ours[:, tanh], expect[:, tanh], rtol=1e-6,
                               atol=1e-6)
