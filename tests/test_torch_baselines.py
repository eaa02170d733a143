"""The port's baseline architectures held against the JAX package on the
CPU: the comm model, ``RoundEngine.run_round`` / ``run``, MD-TGAN's step
and swap, and ``run_centralized`` / ``run_mdtgan`` end to end.

The same numpy-seeded inputs go through both packages; the reference's
random draws are reproduced from its key splits
(``tests/torch_jax_draws.py``) and injected; state is carried over with
``repro_torch.interop``.  The reference's ``md_step`` is a closure of its
``run_mdtgan``: the tests take it from the ``jax.jit`` call that compiles
it.

Tolerances: the comm model's arithmetic is the same float64 arithmetic,
so equal.  Rounds and MD steps as ``tests/test_torch_train.py`` states for
a local round: losses rtol 1e-4, atol 1e-6; Adam moments atol 2e-6;
parameters atol lr per step taken, and 99% of their elements atol 2e-6
(Adam turns rounding-level gradients into lr-sized steps).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro.core import architectures as jarch  # noqa: E402
from repro.core import comm_model as jcomm  # noqa: E402
from repro.fed import setup_federation as jax_setup  # noqa: E402
from repro.gan import ctgan as jctgan  # noqa: E402
from repro.gan import trainer as jtrainer  # noqa: E402
from repro.synth import DeviceSampler as JaxDeviceSampler  # noqa: E402
from repro.synth import RoundEngine as JaxRoundEngine  # noqa: E402
from repro.tabular import datasets as jds  # noqa: E402
from repro.tabular import encoders as jenc  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import architectures as arch  # noqa: E402
from repro_torch.core import comm_model  # noqa: E402
from repro_torch.fed.setup import Federation  # noqa: E402
from repro_torch.gan.ctgan import CTGANConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.synth import DeviceSampler, RoundEngine  # noqa: E402
from torch_jax_draws import (md_step_draws, rounds_noise,  # noqa: E402
                             sampler_draws)

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


def _carry(jstate):
    return interop.gan_state_from_reference(_flatten(jstate), CFG,
                                            device="cpu")


def _assert_params_close(ours, theirs, steps):
    diff = []
    for a, b in zip(ours, theirs, strict=True):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                   atol=CFG.lr * steps)
        diff.append(np.abs(_np(a) - _np(b)).ravel())
    assert np.mean(np.concatenate(diff) <= 2e-6) >= 0.99


def _assert_moments_close(ours, theirs):
    assert ours.count == theirs.count
    for a, b in zip(ours.mu + ours.nu, theirs.mu + theirs.nu, strict=True):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=2e-6)


# ---- the comm model --------------------------------------------------------

@pytest.mark.parametrize("P,steps,batch,dim,disc,swap", [
    (5, 80, 500, 300, 4.1e6, True), (3, 1, 8, 17, 1234.0, False),
    (20, 7, 64, 1, 0.0, True)])
def test_comm_model_matches_reference(P, steps, batch, dim, disc, swap):
    assert (comm_model.md_bytes_per_epoch(P, steps, batch, dim, disc, swap)
            == jcomm.md_bytes_per_epoch(P, steps, batch, dim, disc, swap))
    nbytes = comm_model.fl_bytes_per_round(P, disc + 1.0)
    assert nbytes == jcomm.fl_bytes_per_round(P, disc + 1.0)
    assert comm_model.transfer_seconds(nbytes) == jcomm.transfer_seconds(nbytes)
    assert (comm_model.fl_round_seconds(P, disc, 0.01, steps)
            == jcomm.fl_round_seconds(P, disc, 0.01, steps))
    assert (comm_model.md_epoch_seconds(P, steps, batch, dim, disc, 0.02,
                                        0.03)
            == jcomm.md_epoch_seconds(P, steps, batch, dim, disc, 0.02, 0.03))


# ---- RoundEngine.run_round / run ------------------------------------------

@pytest.fixture(scope="module")
def table():
    """A 400-row adult table, the reference's encoders and encode, and the
    port's encoders carried over."""
    ds = jds.make_dataset("adult", n_rows=400, seed=2)
    enc = jenc.fit_centralized_encoders(ds.data, ds.schema,
                                        jax.random.PRNGKey(2))
    encoded = np.asarray(enc.encode(ds.data, jax.random.PRNGKey(3)))
    vgms = {j: {f: np.asarray(getattr(p, f))
                for f in ("weights", "means", "stds", "valid")}
            for j, p in enc.vgms.items()}
    cats = {j: le.categories for j, le in enc.label_encoders.items()}
    port_enc = interop.encoders_from_reference(ds.schema, vgms, cats,
                                               device="cpu")
    return enc, encoded, port_enc


@pytest.mark.parametrize("rounds", [None, 2])
def test_round_engine_run_matches_reference(table, rounds):
    """``run_round`` (one round) and ``run`` (two rounds in turn) with the
    reference's per-round sampler draws and step noise injected."""
    enc, encoded, port_enc = table
    E, B = 2, CFG.batch_size
    jeng = JaxRoundEngine(CFG, enc.spans(), enc.condition_spans(), batch=B,
                          local_steps=E)
    jstate = jtrainer.init_gan_state(jax.random.PRNGKey(7), CFG, enc.cond_dim,
                                     enc.encoded_dim)
    key = jax.random.PRNGKey(8)
    jtables = JaxDeviceSampler(encoded, enc).tables
    tables = DeviceSampler(encoded, port_enc, "cpu").tables
    n_spans = tables.cum.shape[0]
    ours = RoundEngine(CFG, port_enc.spans(), port_enc.condition_spans(),
                       batch=B, local_steps=E)
    port = _carry(jstate)
    noise = rounds_noise(jstate.rng, CFG, port_enc.spans(), B,
                         port_enc.encoded_dim, E, rounds or 1)
    if rounds is None:
        jnew, jm = jeng.run_round(jstate, jtables, key)
        _, m = ours.run_round(port, tables,
                              draws=sampler_draws(key, E * B, n_spans),
                              noise=noise[0])
    else:
        jnew, jm = jeng.run(jstate, jtables, key, rounds)
        _, m = ours.run(port, tables, rounds,
                        draws=[sampler_draws(k, E * B, n_spans) for k in
                               jax.random.split(key, rounds)],
                        noise=noise)
    assert m["d_loss"].shape == jm["d_loss"].shape
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(_np(m[k]), np.asarray(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    carried = _carry(jnew)
    assert port.step == carried.step == E * (rounds or 1)
    _assert_moments_close(port.g_opt, carried.g_opt)
    _assert_moments_close(port.d_opt, carried.d_opt)
    _assert_params_close(port.params(), carried.params(), E * (rounds or 1))


# ---- MD-TGAN ---------------------------------------------------------------

P_MD = 2


@pytest.fixture(scope="module")
def md_federation():
    """A 2-client IID split of adult, the reference's ``uniform``
    federation on it (client 1's critic redrawn), its ``md_step`` (taken
    from the ``jax.jit`` call of a 0-epoch ``run_mdtgan``), and the
    port's encoders and tables carried over."""
    ds = jds.make_dataset("adult", n_rows=600, seed=4)
    parts = jds.partition_iid(ds, P_MD, seed=4)
    fe = jax_setup(parts, ds.schema, CFG, seed=4, weighting="uniform")
    # the critics start apart (client 1's drawn from another key), so
    # that the swap moves something a step can see
    other = jctgan.init_discriminator(jax.random.PRNGKey(99), CFG,
                                      fe.enc.cond_dim, fe.enc.encoded_dim)
    fe = dataclasses.replace(fe, states=fe.states._replace(
        d_params=jax.tree.map(lambda s, o: s.at[1].set(o),
                              fe.states.d_params, other)))
    compiled = {}
    real_jit = jax.jit

    def capture(fn, *a, **kw):
        compiled[getattr(fn, "__name__", "")] = fn
        return real_jit(fn, *a, **kw)
    jax.jit = capture
    try:
        jarch.run_mdtgan(parts, ds.schema, cfg=CFG, epochs=0, seed=4)
    finally:
        jax.jit = real_jit
    vgms = {j: {f: np.asarray(getattr(p, f))
                for f in ("weights", "means", "stds", "valid")}
            for j, p in fe.enc.vgms.items()}
    cats = {j: le.categories for j, le in fe.enc.label_encoders.items()}
    port_enc = interop.encoders_from_reference(ds.schema, vgms, cats,
                                               device="cpu")
    tables = [DeviceSampler(np.asarray(fe.tables.encoded[i]), port_enc,
                            "cpu").tables for i in range(P_MD)]
    return ds, parts, fe, real_jit(compiled["md_step"]), port_enc, tables


def _port_federation(fe, port_enc, tables):
    """The reference's federation as the port's :class:`Federation`: the
    states carried over, each with its own generator."""
    states = [interop.gan_state_from_reference(
        _flatten(jax.tree.map(lambda x, i=i: x[i], fe.states)), CFG,
        rng=torch.Generator().manual_seed(i), device="cpu")
        for i in range(P_MD)]
    n_rows = torch.tensor(fe.n_rows, dtype=torch.float32)
    return Federation(None, port_enc, tuple(port_enc.spans()),
                      tuple(port_enc.condition_spans()), tables, states,
                      torch.zeros((P_MD, 1)), n_rows,
                      torch.full((P_MD,), 1.0 / P_MD), "uniform", [])


def _md_draws(key, port_enc, tables):
    return md_step_draws(key, CFG, port_enc.spans(), CFG.batch_size,
                         port_enc.encoded_dim, tables[0].cum.shape[0], P_MD)


def test_md_step_matches_reference(md_federation):
    """One MD step from the reference's federation: every critic's
    parameters and moments, the central generator's, and the loss; 2P
    activation forwards and P backwards (autograd on the CPU)."""
    _, _, fe, jstep, port_enc, tables = md_federation
    key = jax.random.PRNGKey(11)
    g0 = jax.tree.map(lambda x: x[0], fe.states)
    jg, jgopt, jd, jgl = jstep(g0.g_params, g0.g_opt, fe.states, fe.tables,
                               key)
    pf = _port_federation(fe, port_enc, tables)
    md_step = arch.make_md_step(CFG, pf.spans, pf.cond_spans, CFG.batch_size)
    draws, noise = _md_draws(key, port_enc, tables)
    gen, g_opt = pf.states[0].gen, pf.states[0].g_opt
    with ops.dispatch_scope() as d:
        g_opt, m = md_step(gen, g_opt, pf.states, tables, draws=draws,
                           noise=noise)
    assert dict(d) == {"segment_activations_ref": 2 * P_MD}
    np.testing.assert_allclose(float(m["g_loss"]), float(jgl), rtol=1e-4,
                               atol=1e-6)
    assert m["d_loss"].shape == (P_MD,)
    assert bool(torch.isfinite(m["d_loss"]).all())
    theirs = _carry(jax.tree.map(lambda x: x[0], fe.states)._replace(
        g_params=jg, g_opt=jgopt))
    _assert_moments_close(g_opt, theirs.g_opt)
    _assert_params_close(list(gen.parameters()),
                         list(theirs.gen.parameters()), 1)
    for p in range(P_MD):
        critic = _carry(jax.tree.map(lambda x, p=p: x[p], jd))
        _assert_moments_close(pf.states[p].d_opt, critic.d_opt)
        _assert_params_close(list(pf.states[p].disc.parameters()),
                             list(critic.disc.parameters()), 1)


MD_RUN = dict(cfg=CFG, epochs=2, steps_per_epoch=1, seed=4,
              eval_every=1, eval_samples=50)


@pytest.fixture(scope="module")
def md_reference(md_federation):
    """The reference's ``run_mdtgan`` over the fixture's federation: two
    epochs of one step, the swap between them, an evaluation after
    each."""
    ds, parts, fe = md_federation[:3]
    real = jarch.setup_federation
    jarch.setup_federation = lambda *a, **kw: fe
    try:
        return jarch.run_mdtgan(parts, ds.schema, swap=True,
                                eval_real=ds.data, **MD_RUN)
    finally:
        jarch.setup_federation = real


@pytest.mark.parametrize("swap", [True, False])
def test_run_mdtgan_swap_matches_reference(md_federation, md_reference,
                                           monkeypatch, swap):
    """Two MD epochs of one step with the critic swap in between: the
    port's ``run_mdtgan`` from the reference's federation, fed the
    reference's per-step draws, ends with the reference's generator and
    last loss.  The swap (seed 4: the permutation [1, 0]) moves each
    critic to the other client's data; without it the second step's loss
    is another."""
    ds, parts, fe, _, port_enc, tables = md_federation
    key = jax.random.PRNGKey(4 + 1)          # run_mdtgan's step keys
    keys = []
    for _ in range(2):
        key, k = jax.random.split(key)
        keys.append(k)
    monkeypatch.setattr(arch, "setup_federation",
                        lambda *a, **kw: _port_federation(fe, port_enc,
                                                          tables))
    real = arch.make_md_step

    def injected(*a, **kw):
        step, it = real(*a, **kw), iter(keys)

        def run(gen, g_opt, d_states, tbs):
            draws, noise = _md_draws(next(it), port_enc, tables)
            return step(gen, g_opt, d_states, tbs, draws=draws, noise=noise)
        return run
    monkeypatch.setattr(arch, "make_md_step", injected)
    ours = arch.run_mdtgan(parts, ds.schema, swap=swap, eval_real=ds.data,
                           device="cpu", **MD_RUN)
    rep, jrep = ours.history[-1], md_reference.history[-1]
    if not swap:           # off by 10x the loss tolerance at least
        assert abs(rep["g_loss"] - jrep["g_loss"]) > 1e-3 * abs(jrep["g_loss"])
        return
    np.testing.assert_allclose(rep["g_loss"], jrep["g_loss"], rtol=1e-4,
                               atol=1e-6)
    theirs = interop.generator_from_reference(
        _flatten(md_reference.final_g_params), device="cpu")
    _assert_params_close(list(ours.final_g_params.parameters()),
                         list(theirs.parameters()), 2)


# ---- the baselines end to end ---------------------------------------------

@pytest.fixture(scope="module")
def small():
    ds = jds.make_dataset("adult", n_rows=360, seed=6)
    return ds, jds.partition_iid(ds, 3, seed=6)


def test_run_centralized_on_the_cpu(small):
    """Two epochs of 3 steps, an evaluation after each: the reference's
    result shape, finite reports, one encode, 2 activation forwards per
    step and one per evaluation."""
    ds, _ = small
    kw = dict(cfg=CFG, epoch_steps=3, epochs=2, seed=0, eval_real=ds.data,
              eval_every=1, eval_samples=100)
    ref = jarch.run_centralized(ds.data, ds.schema, **kw)
    epochs = []
    with ops.dispatch_scope() as d:
        res = arch.run_centralized(
            ds.data, ds.schema, device="cpu",
            on_epoch=lambda ep, m: epochs.append((ep, m["d_loss"].shape)),
            **kw)
    assert epochs == [(0, (3,)), (1, (3,))]
    assert dict(d) == {"vgm_encode_table_ref": 1,
                       "segment_activations_ref": 2 * 2 * 3 + 2,
                       "vgm_decode_table_ref": 2}
    assert res.name == ref.name == "centralized"
    assert res.comm_bytes_per_round == ref.comm_bytes_per_round == 0.0
    np.testing.assert_array_equal(res.weights, ref.weights)
    assert len(res.history) == len(ref.history) == 2
    for ours, theirs in zip(res.history, ref.history):
        assert set(ours) == set(theirs)
        assert ours["round"] == theirs["round"]
        assert all(np.isfinite(ours[k]) for k in ours)
    assert (res.retries, res.blocked, res.epsilon) == (0, None, None)


def test_run_mdtgan_on_the_cpu(md_federation, md_reference):
    """The port's own ``run_mdtgan`` (its own setup and noise) over the
    reference run's data: the reference's result shape and bytes per
    epoch, finite reports, 2P activation forwards per step and one per
    evaluation, no merge."""
    ds, parts = md_federation[:2]
    with ops.dispatch_scope() as d:
        res = arch.run_mdtgan(parts, ds.schema, eval_real=ds.data,
                              device="cpu", **MD_RUN)
    ref = md_reference
    assert d["segment_activations_ref"] == 2 * (2 * P_MD) + 2
    assert d["vgm_encode_table_ref"] == P_MD
    assert ops.stage_dispatches(d, "weighted_agg") == 0
    assert res.name == ref.name == "md-tgan"
    assert res.comm_bytes_per_round == ref.comm_bytes_per_round > 0
    np.testing.assert_array_equal(res.weights, ref.weights)
    assert len(res.history) == len(ref.history) == 2
    for ours, theirs in zip(res.history, ref.history):
        assert set(ours) == set(theirs)
        assert ours["round"] == theirs["round"]
        assert all(np.isfinite(ours[k]) for k in ours)


def test_baselines_need_a_card_unless_cpu_is_asked(small):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    ds, parts = small
    with pytest.raises(RuntimeError, match="no CUDA device"):
        arch.run_centralized(ds.data, ds.schema, cfg=CFG, epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        arch.run_mdtgan(parts, ds.schema, cfg=CFG, epochs=1)
