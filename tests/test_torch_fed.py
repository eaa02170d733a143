"""The port's federation slice held against the JAX package on the CPU.

The same numpy-seeded inputs go through the reference and the port; the
reference's random draws are reproduced from its key splits
(``tests/torch_jax_draws.py``) and injected; state is carried over with
``repro_torch.interop``.  The Pallas merge runs in interpret mode.

Tolerances:
  * merges: rtol 1e-6, atol 1e-7 -- the same float32 products summed in
    client order; the weights' normalization may round an ulp apart.  An
    all-zero edge gives exact zeros.
  * §4.2 weights, JSD, Wasserstein: rtol 1e-5 -- float32 logs, sorts,
    quantiles and softmax in the two libraries.  The categorical columns
    of the divergence matrix are the same float32 JSD of the same
    frequencies, yet not bit-equal: atol 5e-6.  A client's frequencies
    are close to the global ones, so the JSD is the square root of a sum
    of nearly cancelling ``p * log2(p / m)`` terms, and XLA's and
    PyTorch's float32 log2 differ by an ulp; on this split each package
    is within 3e-6 of the float64 value.
  * federated encoder init: label encoders and every frequency table
    equal; each global VGM's mixture mean within 5% of the column's std
    and its std within 10%, since the bootstrap draws and the EM's
    starting jitter come from two different generators.
  * one global round: as ``tests/test_torch_train.py`` states for a
    local round (moments atol 2e-6, parameters atol lr per step and 99%
    of elements atol 2e-6); every client's merged parameters are equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro.core import divergence as jdv  # noqa: E402
from repro.core import encoding as jencoding  # noqa: E402
from repro.core import weighting as jweighting  # noqa: E402
from repro.fed import FederatedProgram as JaxProgram  # noqa: E402
from repro.fed import merge as jmerge  # noqa: E402
from repro.fed import setup_federation as jax_setup  # noqa: E402
from repro.gan import ctgan as jctgan  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.weighted_agg import weighted_agg as pallas_agg  # noqa: E402
from repro.tabular import datasets as jds  # noqa: E402
from repro.tabular import metrics as jmetrics  # noqa: E402
from repro.tabular.vgm import sample_vgm as jax_sample_vgm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import aggregation, divergence  # noqa: E402
from repro_torch.core import encoding, weighting  # noqa: E402
from repro_torch.core.architectures import run_federated  # noqa: E402
from repro_torch.fed import (FederatedProgram, MergeLayoutError,  # noqa: E402
                             flatten_stacked, fused_weighted_merge,
                             tiered_weighted_merge,
                             tiered_weighted_merge_flat, unflatten_merged)
from repro_torch.gan.ctgan import CTGANConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.synth import DeviceSampler  # noqa: E402
from repro_torch.tabular import metrics  # noqa: E402
from torch_jax_draws import round_noise, sampler_draws  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

CFG = CTGANConfig(z_dim=8, gen_hidden=(16, 16), disc_hidden=(16, 16),
                  pac=2, batch_size=8)


@pytest.fixture(scope="module", autouse=True)
def _full_precision():
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on one machine,
    and torch's thread pools would oversubscribe its cores many times
    over on these small ops (a run of seconds took minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy()


# ---- the merge kernel's plain versions ------------------------------------

@pytest.mark.parametrize("P,D,block_d,zeros", [
    (5, 1000, 128, ()),            # D not a multiple of the block
    (4, 777, 256, (0, 2)),         # zero weights drop their clients
    (3, 64, 64, (0, 1, 2)),        # all weights 0: exact zeros
])
def test_weighted_agg_plain_matches_pallas_and_ref(P, D, block_d, zeros):
    rng = np.random.default_rng(P * D)
    stacked = rng.normal(size=(P, D)).astype(np.float32)
    w = rng.random(P).astype(np.float32)
    w[list(zeros)] = 0.0
    pallas = np.asarray(pallas_agg(jnp.asarray(stacked), jnp.asarray(w),
                                   block_d=block_d, interpret=True))
    oracle = np.asarray(jax.jit(jops.ref.weighted_agg_ref)(
        jnp.asarray(stacked), jnp.asarray(w)))
    with ops.dispatch_scope() as d:
        port = _np(ops.weighted_average_flat(torch.from_numpy(stacked),
                                             torch.from_numpy(w)))
    assert dict(d) == {"weighted_agg_ref": 1}
    assert port.shape == (D,)
    for other in (pallas, oracle):
        np.testing.assert_allclose(port, other, rtol=1e-6, atol=1e-7)
    if len(zeros) == P:
        assert not np.signbit(port).any() and not port.any()


def test_weighted_agg_edges_plain_matches_reference():
    """The edge form: every edge in one dispatch, an all-zero edge gives
    exact +0.0, the others the per-edge flat merge."""
    rng = np.random.default_rng(1)
    E, C, D = 3, 2, 333
    stacked = rng.normal(size=(E, C, D)).astype(np.float32)
    w = rng.random((E, C)).astype(np.float32)
    w[1] = 0.0
    expect = np.asarray(jops.weighted_average_edges(
        jnp.asarray(stacked), jnp.asarray(w), use_pallas=True,
        interpret=True, block_d=128))
    with ops.dispatch_scope() as d:
        port = _np(ops.weighted_average_edges(torch.from_numpy(stacked),
                                              torch.from_numpy(w)))
    assert dict(d) == {"weighted_agg_ref": 1}
    np.testing.assert_allclose(port, expect, rtol=1e-6, atol=1e-7)
    assert not port[1].any() and not np.signbit(port[1]).any()
    for e in (0, 2):
        np.testing.assert_allclose(
            port[e], _np(tref.weighted_agg_ref(torch.from_numpy(stacked[e]),
                                               torch.from_numpy(w[e]))),
            rtol=1e-6, atol=1e-7)


# ---- §4.2 weights and divergences -----------------------------------------

def test_weights_match_reference():
    rng = np.random.default_rng(2)
    S = rng.random((5, 6)).astype(np.float32)
    S[:, 3] = 0.0                                   # an all-zero column
    n = np.array([500, 40000, 800, 800, 1200], np.float32)
    pairs = [
        (weighting.weights_from_divergence(torch.from_numpy(S),
                                           torch.from_numpy(n)),
         jweighting.weights_from_divergence(jnp.asarray(S), jnp.asarray(n))),
        (weighting.uniform_weights(5), jweighting.uniform_weights(5)),
        (weighting.quantity_only_weights(torch.from_numpy(n)),
         jweighting.quantity_only_weights(jnp.asarray(n)))]
    for ours, theirs in pairs:
        np.testing.assert_allclose(_np(ours), np.asarray(theirs), rtol=1e-5)
        assert abs(float(ours.sum()) - 1.0) < 1e-6


def test_divergences_match_reference():
    rng = np.random.default_rng(3)
    p, q = rng.random((4, 7)), rng.random((4, 7))
    p[0, 2] = 0.0
    np.testing.assert_allclose(_np(divergence.jsd(p, q)),
                               np.asarray(jdv.jsd(p, q)), rtol=1e-5)
    np.testing.assert_allclose(_np(divergence.kl(p, q)),
                               np.asarray(jdv.kl(p, q)), rtol=1e-5)
    assert float(divergence.jsd(p[1], p[1])) == 0.0
    u = rng.normal(size=500)
    v = rng.normal(0.5, 2.0, size=731)                  # counts differ
    np.testing.assert_allclose(float(divergence.wasserstein_1d(u, v)),
                               float(jdv.wasserstein_1d(u, v)), rtol=1e-5)


@pytest.fixture(scope="module")
def federation():
    """A 2-client IID split of adult and the reference's federation on it
    (fedtgan weighting), with the port's encoders carried over."""
    ds = jds.make_dataset("adult", n_rows=600, seed=4)
    parts = jds.partition_iid(ds, 2, seed=4)
    fe = jax_setup(parts, ds.schema, CFG, seed=4, weighting="fedtgan")
    vgms = {j: {f: np.asarray(getattr(p, f))
                for f in ("weights", "means", "stds", "valid")}
            for j, p in fe.enc.vgms.items()}
    cats = {j: le.categories for j, le in fe.enc.label_encoders.items()}
    port_enc = interop.encoders_from_reference(ds.schema, vgms, cats,
                                               device="cpu")
    return ds, parts, fe, port_enc


def test_divergence_matrix_matches_reference(federation):
    """Categorical columns exactly the reference's JSD; continuous columns
    with the reference's VGM samples injected."""
    ds, _, fe, port_enc = federation
    stats = fe.client_stats
    key = jax.random.PRNGKey(5)
    expect = np.asarray(jweighting.build_divergence_matrix(
        ds.schema, fe.init.client_cat_freqs, [s.vgms for s in stats],
        fe.enc, fe.init.global_cat_freqs, key, wd_samples=1024))
    P, Q = expect.shape
    keys = jax.random.split(key, P * Q)
    samples = {}
    for i in range(P):
        for j, col in enumerate(ds.schema):
            if col.kind == "continuous":
                kij = keys[i * Q + j]
                samples[i, j] = (
                    np.asarray(jax_sample_vgm(stats[i].vgms[j], kij, 1024)),
                    np.asarray(jax_sample_vgm(fe.enc.vgms[j],
                                              jax.random.fold_in(kij, 7),
                                              1024)))
    ours = _np(weighting.build_divergence_matrix(
        ds.schema, fe.init.client_cat_freqs, [{} for _ in range(P)],
        port_enc, fe.init.global_cat_freqs, samples=samples))
    cat = [j for j, c in enumerate(ds.schema) if c.kind == "categorical"]
    cont = [j for j, c in enumerate(ds.schema) if c.kind == "continuous"]
    np.testing.assert_allclose(ours[:, cat], expect[:, cat], rtol=0,
                               atol=5e-6)
    np.testing.assert_allclose(ours[:, cont], expect[:, cont], rtol=1e-5,
                               atol=1e-7)
    assert (ours[:, cont] > 0).all()


def _mixture_moments(v):
    w = np.where(np.asarray(v.valid), np.asarray(v.weights), 0.0)
    w = w / w.sum()
    mu, sd = np.asarray(v.means), np.asarray(v.stds)
    mean = float(np.sum(w * mu))
    return mean, float(np.sqrt(np.sum(w * (sd ** 2 + mu ** 2)) - mean ** 2))


def test_federated_encoder_init_matches_reference(federation):
    ds, parts, fe, _ = federation
    stats = [encoding.compute_client_stats(
        d, ds.schema, device="cpu",
        generator=torch.Generator().manual_seed(i))
        for i, d in enumerate(parts)]
    init = encoding.federated_encoder_init(
        stats, ds.schema, device="cpu", generator=torch.Generator()
        .manual_seed(9))
    assert init.n_rows == fe.init.n_rows and init.n_total == 600
    for j, le in fe.enc.label_encoders.items():
        np.testing.assert_array_equal(init.encoders.label_encoders[j]
                                      .categories, le.categories)
        np.testing.assert_array_equal(init.global_cat_freqs[j],
                                      fe.init.global_cat_freqs[j])
        for i in range(2):
            np.testing.assert_array_equal(init.client_cat_freqs[i][j],
                                          fe.init.client_cat_freqs[i][j])
    for s, js in zip(stats, fe.client_stats):
        assert s.cat_freqs == js.cat_freqs and s.n_rows == js.n_rows
    for j, v in fe.enc.vgms.items():
        col_std = float(np.std(ds.data[:, j]))
        (m0, s0), (m1, s1) = (_mixture_moments(v),
                              _mixture_moments(init.encoders.vgms[j]))
        assert abs(m0 - m1) <= 0.05 * col_std, (j, m0, m1)
        assert abs(s0 - s1) <= 0.1 * s0, (j, s0, s1)


def test_similarity_report_matches_reference(federation):
    ds, parts, _, _ = federation
    real, synth = parts
    ours = metrics.similarity_report(real, synth, ds.schema)
    theirs = jmetrics.similarity_report(real, synth, ds.schema)
    for k in ("avg_jsd", "avg_wd"):
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-5)


# ---- the fused merge -------------------------------------------------------

@pytest.fixture(scope="module")
def client_models():
    """Four clients' generator and critic parameters: the reference's
    stacked tree and the port's per-client lists (same values)."""
    trees = []
    for p in range(4):
        k = jax.random.PRNGKey(20 + p)
        trees.append({"g": jctgan.init_generator(k, CFG, 5, 11),
                      "d": jctgan.init_discriminator(k, CFG, 5, 11)})
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    port = []
    for tree in trees:
        g = interop.generator_from_reference(_flatten(tree["g"]),
                                             device="cpu")
        d = interop.discriminator_from_reference(
            _flatten(tree["d"]), pac=CFG.pac, dropout=CFG.dropout,
            device="cpu")
        port.append(list(g.parameters()) + list(d.parameters()))
    return stacked, port


def _merged_as_port(merged_tree):
    g = interop.generator_from_reference(_flatten(merged_tree["g"]),
                                         device="cpu")
    d = interop.discriminator_from_reference(_flatten(merged_tree["d"]),
                                             pac=CFG.pac, dropout=CFG.dropout,
                                             device="cpu")
    return list(g.parameters()) + list(d.parameters())


@pytest.mark.parametrize("edges", [None, 2])
def test_fused_merge_matches_reference(client_models, edges):
    stacked, port = client_models
    w = np.array([0.1, 0.4, 0.3, 0.2], np.float32)
    if edges is None:
        expect = jmerge.fused_weighted_merge(stacked, jnp.asarray(w))
        with ops.dispatch_scope() as d:
            ours = fused_weighted_merge(port, torch.from_numpy(w))
    else:
        expect = jmerge.tiered_weighted_merge(stacked, jnp.asarray(w), edges)
        with ops.dispatch_scope() as d:
            ours = tiered_weighted_merge(port, torch.from_numpy(w), edges)
    assert dict(d) == {"weighted_agg_ref": 1 if edges is None else 2}
    oracle = aggregation.weighted_average(
        [torch.stack(ts) for ts in zip(*port)], torch.from_numpy(w))
    for a, b, c in zip(ours, _merged_as_port(expect), oracle, strict=True):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(_np(a), _np(c), rtol=1e-6, atol=1e-7)


def test_tiered_merge_masks_an_all_zero_edge():
    rng = np.random.default_rng(6)
    flat = torch.from_numpy(rng.normal(size=(4, 50)).astype(np.float32))
    w = torch.tensor([0.0, 0.0, 0.25, 0.75])
    np.testing.assert_allclose(
        _np(tiered_weighted_merge_flat(flat, w, 2)),
        _np(ops.weighted_average_flat(flat, w)), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="divide"):
        tiered_weighted_merge_flat(flat, w, 3)


def test_merge_layout_errors(client_models):
    _, port = client_models
    flat = flatten_stacked(port)
    assert flat.shape == (4, sum(t.numel() for t in port[0]))
    with pytest.raises(MergeLayoutError, match="needs"):
        unflatten_merged(torch.zeros(flat.shape[1] + 1), port[0])
    with pytest.raises(MergeLayoutError, match="needs"):
        unflatten_merged(flat, port[0])               # still (P, D)
    with pytest.raises(MergeLayoutError, match="other parameter shapes"):
        flatten_stacked([port[0], port[1][:-1]])
    back = unflatten_merged(flat[2], port[0])
    for a, b in zip(back, port[2]):
        assert torch.equal(a, b)


# ---- one global round and the driver ---------------------------------------

def test_global_round_matches_reference(federation):
    """One ``FederatedProgram`` round from the reference's federation,
    carried over, with every client's sampler draws and step noise
    injected: losses, the merged model and each client's moments."""
    ds, parts, fe, port_enc = federation
    prog = JaxProgram(CFG, fe.spans, fe.cond_spans, batch=CFG.batch_size,
                      local_steps=2, weighting="fedtgan")
    key = jax.random.PRNGKey(13)
    jstates, jm = prog.round(fe.states, fe.tables, fe.S, fe.n_rows, key)

    P, E, B = 2, 2, CFG.batch_size
    k_enc = jax.random.split(jax.random.PRNGKey(4), 5)[4]
    tables = [DeviceSampler(np.asarray(fe.enc.encode(
        d, jax.random.fold_in(k_enc, i))), port_enc, "cpu").tables
        for i, d in enumerate(parts)]
    for i, tb in enumerate(tables):
        np.testing.assert_array_equal(_np(tb.encoded),
                                      np.asarray(fe.tables.encoded[i]))
    states = [interop.gan_state_from_reference(
        _flatten(jax.tree.map(lambda x, i=i: x[i], fe.states)), CFG,
        device="cpu") for i in range(P)]
    keys = jax.random.split(key, P)
    n_spans = tables[0].cum.shape[0]
    ours = FederatedProgram(CFG, port_enc.spans(), port_enc.condition_spans(),
                            batch=B, local_steps=E, weighting="fedtgan")
    with ops.dispatch_scope() as d:
        states, m = ours.global_round(
            states, tables, torch.from_numpy(np.array(fe.S)),
            torch.from_numpy(np.array(fe.n_rows)),
            draws=[sampler_draws(keys[i], E * B, n_spans) for i in range(P)],
            noise=[round_noise(fe.states.rng[i], CFG, port_enc.spans(), B,
                               port_enc.encoded_dim, E) for i in range(P)])
    assert d["weighted_agg_ref"] == 1
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(_np(m[k]), np.asarray(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for a, b in zip(states[0].params(), states[1].params()):
        assert torch.equal(a, b)
    diff = []
    for i in range(P):
        theirs = interop.gan_state_from_reference(
            _flatten(jax.tree.map(lambda x, i=i: x[i], jstates)), CFG,
            device="cpu")
        for a, b in zip(states[i].params(), theirs.params(), strict=True):
            np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                       atol=CFG.lr * E)
            diff.append(np.abs(_np(a) - _np(b)).ravel())
        for ours_opt, their_opt in ((states[i].g_opt, theirs.g_opt),
                                    (states[i].d_opt, theirs.d_opt)):
            for a, b in zip(ours_opt.mu + ours_opt.nu,
                            their_opt.mu + their_opt.nu, strict=True):
                np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=2e-6)
    assert np.mean(np.concatenate(diff) <= 2e-6) >= 0.99


@pytest.mark.parametrize("edges", [None, 2])
def test_run_federated_on_the_cpu(edges):
    """Clients equal after every merge, one merge dispatch per tier and
    round, finite losses and an evaluation at the end."""
    ds = jds.make_dataset("adult", n_rows=360, seed=6)
    P = 4 if edges else 3
    parts = jds.partition_iid(ds, P, seed=6)
    seen = []

    def on_round(r, states, m):
        ref = states[0].params()
        for st in states[1:]:
            assert all(torch.equal(a, b) for a, b in zip(ref, st.params()))
        assert all(bool(torch.isfinite(v).all()) for v in m.values())
        assert m["d_loss"].shape == (P, 2)
        seen.append(r)

    with ops.dispatch_scope() as d:
        res = run_federated(parts, ds.schema, cfg=CFG, rounds=2,
                            local_steps=2, seed=6, eval_real=ds.data,
                            eval_every=5, eval_samples=200, edges=edges,
                            on_round=on_round, device="cpu")
    assert seen == [0, 1]
    assert d["weighted_agg_ref"] == 2 * (2 if edges else 1)
    assert "weighted_agg" not in d
    assert abs(res.weights.sum() - 1.0) < 1e-6 and res.weights.shape == (P,)
    [rep] = res.history
    assert rep["round"] == 2
    assert all(np.isfinite(rep[k]) for k in ("avg_jsd", "avg_wd", "d_loss",
                                             "g_loss"))
    n_params = sum(p.numel() for p in res.final_g_params.parameters())
    assert res.comm_bytes_per_round > 2 * P * 4 * n_params


@pytest.mark.parametrize("option", [
    dict(client_chunk=1), dict(dp="DPConfig"), dict(trace="RoundTrace")])
def test_unported_options_raise(option):
    """The options once refused run a round instead: ``dp`` and ``trace``
    (ported in an earlier slice), and ``client_chunk``, whose run equals
    the dense run bit for bit (``program="fed"``; the host program's in
    ``tests/test_torch_scale.py``)."""
    from repro_torch.gan.dp import DPConfig
    from repro_torch.privacy import RoundTrace
    ds = jds.make_dataset("adult", n_rows=64, seed=0)
    if "client_chunk" in option:
        kw = dict(cfg=CFG, rounds=1, local_steps=2, device="cpu")
        dense = run_federated(jds.partition_iid(ds, 2), ds.schema, **kw)
        res = run_federated(jds.partition_iid(ds, 2), ds.schema, **kw,
                            **option)
        for a, b in zip(dense.final_g_params.parameters(),
                        res.final_g_params.parameters()):
            assert torch.equal(a, b)
        return
    arg = DPConfig() if "dp" in option else RoundTrace()
    res = run_federated(jds.partition_iid(ds, 2), ds.schema, cfg=CFG,
                        rounds=1, device="cpu", **{next(iter(option)): arg})
    if "dp" in option:
        assert res.epsilon == DPConfig().epsilon(1, CFG.batch_size, 32)
    else:
        assert arg.n_rounds == 1 and arg.meta["dp"] is False


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    ds = jds.make_dataset("adult", n_rows=64, seed=0)
    parts = jds.partition_iid(ds, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_federated(parts, ds.schema, cfg=CFG, rounds=1)
    from repro_torch.fed import setup_federation
    with pytest.raises(RuntimeError, match="no CUDA device"):
        setup_federation(parts, ds.schema, CFG, 0)
