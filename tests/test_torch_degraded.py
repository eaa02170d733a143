"""The port's degraded federation held against the JAX package on the CPU:
fault plans, the guard's median, the faulted round, partial
participation, FedProx, checkpoints across the two packages, resume, the
retry blocklist, and the host oracle against the fused program.

The same numpy-seeded inputs go through both packages; the reference's
random draws are reproduced from its key splits
(``tests/torch_jax_draws.py``) and injected; state is carried over with
``repro_torch.interop``; the reference merges through its jnp oracle
(its Pallas merge is held to the port's in ``tests/test_torch_fed.py``).  Plans
and participation draw from a ``torch.Generator`` in the port and from a
key in the reference, so the plan functions are held to their semantics
(rates, rescue, determinism), and the rounds are fed the same plan.

Tolerances: the guard's decisions (``client_ok``, ``client_suspect``,
``merged``) are equal; ``w_eff`` rtol 1e-5; each ``update_norm`` within
the distance between the two packages' local-round results (times the
client's byzantine scale) plus rtol 1e-6: by the triangle inequality the
norms of two deltas from the same start differ by at most that distance,
and Adam makes it lr-sized in a few elements (measured up to 4.5e-5 of
the norm at this width, so a flat rtol 1e-5 would not hold); parameters after a
round as ``tests/test_torch_fed.py`` states for a global round (moments
atol 2e-6, parameters atol lr per step and 99% of elements atol 2e-6),
the atol times the largest byzantine scale that survives the guard (the
merge adds ``scale x delta``).
Within the port: a neutral plan gives the dense round's parameters
exactly, an all-masked round keeps them exactly, a resumed run ends
bit-identical to the uninterrupted one, and the host oracle's per-leaf
merge agrees with the fused merge at the merge tolerance (rtol 1e-6, atol
1e-7) after a round.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore_fed_checkpoint as jax_restore  # noqa: E402
from repro.checkpoint import save_fed_checkpoint as jax_save  # noqa: E402
from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro.core import fedavg as jfedavg  # noqa: E402
from repro.fed import FederatedProgram as JaxProgram  # noqa: E402
from repro.fed import faults as jfaults  # noqa: E402
from repro.fed import setup_federation as jax_setup  # noqa: E402
from repro.fed.program import _gan_lens, _gan_merge  # noqa: E402
from repro.fed.program import resolve_weights as jax_weights  # noqa: E402
from repro.gan import trainer as jtrainer  # noqa: E402
from repro.synth import draw_batch as jdraw  # noqa: E402
from repro.tabular import datasets as jds  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import (TORCH_RNG_KEY,  # noqa: E402
                                    latest_step, restore_fed_checkpoint,
                                    save_fed_checkpoint)
from repro_torch.core.architectures import run_federated  # noqa: E402
from repro_torch.core.fedavg import (fedprox_wrap,  # noqa: E402
                                     sample_client_weights,
                                     sample_participation)
from repro_torch.fed import (FaultPlan, FederatedProgram,  # noqa: E402
                             NoSurvivingClients, PoisonedRunError,
                             UpdateGuard, apply_faults, apply_faults_tree,
                             byzantine_scale, compose, corrupt_nans,
                             dropout_uniform, guard_ok, no_faults,
                             resolve_weights, sanitize_stacked,
                             straggler_deadline, update_diagnostics)
from repro_torch.fed.faults import _nanmedian  # noqa: E402
from repro_torch.gan.ctgan import CTGANConfig  # noqa: E402
from repro_torch.gan.trainer import make_train_steps  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.synth import DeviceSampler  # noqa: E402
from torch_jax_draws import round_noise, sampler_draws, step_noise  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

CFG = CTGANConfig(z_dim=8, gen_hidden=(16, 16), disc_hidden=(16, 16),
                  pac=2, batch_size=8)
P, E = 4, 2


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


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ---- plans, the guard's math -----------------------------------------------

def test_plans_are_deterministic_in_their_generator():
    for build in (lambda g: dropout_uniform(g, 8, 12, rate=0.4),
                  lambda g: straggler_deadline(g, 8, 12),
                  lambda g: corrupt_nans(g, 8, 12, n_corrupt=2, prob=0.5),
                  lambda g: byzantine_scale(g, 8, 12, n_byzantine=3)):
        a, b, c = build(_gen(0)), build(_gen(0)), build(_gen(1))
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert any(not torch.equal(x, y) for x, y in zip(a, c))
        assert all(x.device.type == "cpu" for x in a)
        assert tuple(a.participate.shape) == (8, 12)


def test_dropout_and_straggler_rates():
    """Per-client miss rates pass a chi-squared test (11 dof, p = 0.001:
    31.26) at ``rate`` and at ``exp(-deadline / mean)``."""
    R, C = 4000, 12
    for plan, rate in ((dropout_uniform(_gen(2), R, C, rate=0.3,
                                        min_participants=0), 0.3),
                       (straggler_deadline(_gen(3), R, C, deadline=1.0,
                                           min_participants=0),
                        float(np.exp(-1.0)))):
        missed = (~plan.participate).sum(0).numpy().astype(float)
        exp = R * rate
        chi2 = float(((missed - exp) ** 2 / (exp * (1 - rate))).sum())
        assert chi2 < 31.26, (chi2, missed / R)


def test_min_participants_never_empty_and_compose():
    plan = dropout_uniform(_gen(4), 200, 3, rate=0.95)
    assert bool(plan.participate.any(1).all())
    a = dropout_uniform(_gen(5), 6, 4, rate=0.5)
    b = corrupt_nans(_gen(6), 6, 4, clients=[1])
    c = byzantine_scale(_gen(7), 6, 4, clients=[1, 2], scale=3.0)
    d = byzantine_scale(_gen(7), 6, 4, clients=[2], scale=2.0)
    out = compose(a, b, c, d)
    assert torch.equal(out.participate, a.participate)
    assert torch.equal(out.nan_mask, b.nan_mask)
    np.testing.assert_array_equal(out.scale[0].numpy(), [1, 3, 6, 1])
    with pytest.raises(ValueError, match="disagree"):
        compose(a, no_faults(5, 4))
    assert out.summary() == {
        "rounds": 6, "clients": 4,
        "dropout_rate": float(1.0 - a.participate.numpy().mean()),
        "nan_client_rounds": 6, "byzantine_client_rounds": 12}


def test_validate_block_and_slice():
    plan = no_faults(3, 2)._replace(
        participate=torch.tensor([[1, 1], [0, 0], [1, 0]], dtype=torch.bool))
    with pytest.raises(NoSurvivingClients, match=r"\[1\]"):
        plan.validate()
    sl = plan.slice_rounds(2, 3)
    assert sl.rounds == 1 and sl.n_clients == 2
    blocked = no_faults(2, 3).block_clients(np.array([False, True, False]))
    np.testing.assert_array_equal(blocked.participate.numpy(),
                                  [[1, 0, 1], [1, 0, 1]])


@pytest.mark.parametrize("values,valid", [
    ([1, 2, 3, 4, 0], [1, 1, 1, 1, 0]),      # even count: 2.5, not 2
    ([5, 1, 3], [1, 1, 1]),
    ([7, 3, 9, 8, 2, 4], [1, 0, 1, 1, 0, 1]),
    ([1, 2], [0, 0]),                        # empty: NaN
    ([3], [1])])
def test_median_is_the_references(values, valid):
    x = np.asarray(values, np.float32)
    ok = np.asarray(valid, bool)
    expect = float(jnp.nanmedian(jnp.where(ok, x, jnp.nan)))
    got = float(_nanmedian(torch.from_numpy(x), torch.from_numpy(ok)))
    np.testing.assert_equal(got, expect)


def test_fault_math_matches_reference():
    """``apply_faults`` (honest rows bit-transparent), its per-leaf twin,
    the diagnostics, ``guard_ok`` and ``sanitize_stacked``."""
    rng = np.random.default_rng(0)
    prev = rng.normal(size=(5, 300)).astype(np.float32)
    new = prev + 1e-3 * rng.normal(size=(5, 300)).astype(np.float32)
    nan = np.array([0, 0, 1, 0, 0], bool)
    scale = np.array([1, 64, 1, 1, 1], np.float32)
    part = np.array([1, 1, 1, 0, 1], bool)
    ours = apply_faults(*(torch.from_numpy(a) for a in (new, prev, nan,
                                                         scale)))
    theirs = np.asarray(jfaults.apply_faults(new, prev, nan, scale))
    np.testing.assert_array_equal(_np(ours)[[0, 3, 4]], new[[0, 3, 4]])
    assert np.isnan(_np(ours)[2]).all()
    np.testing.assert_allclose(_np(ours), theirs, rtol=1e-6, atol=1e-7)
    tree = apply_faults_tree([torch.from_numpy(new[:, :100]),
                              torch.from_numpy(new[:, 100:].reshape(5, 4, 50))],
                             [torch.from_numpy(prev[:, :100]),
                              torch.from_numpy(prev[:, 100:].reshape(5, 4, 50))],
                             torch.from_numpy(nan), torch.from_numpy(scale))
    np.testing.assert_array_equal(
        np.concatenate([_np(tree[0]), _np(tree[1]).reshape(5, -1)], 1),
        _np(ours))
    diag = update_diagnostics(ours, torch.from_numpy(prev),
                              torch.from_numpy(part))
    jdiag = jfaults.update_diagnostics(jnp.asarray(theirs), prev, part)
    for k in ("finite", "norm_ok", "suspect"):
        np.testing.assert_array_equal(_np(diag[k]), np.asarray(jdiag[k]))
    np.testing.assert_allclose(_np(diag["norm"]), np.asarray(jdiag["norm"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(_np(diag["suspect"]), [0, 1, 1, 0, 0])
    for guard in (None, UpdateGuard(), UpdateGuard(norm_mult=0.0)):
        np.testing.assert_array_equal(
            _np(guard_ok(guard, diag, torch.from_numpy(part))),
            np.asarray(jfaults.guard_ok(
                None if guard is None else jfaults.UpdateGuard(
                    guard.nonfinite, guard.norm_mult), jdiag, part)))
    safe = sanitize_stacked(tree, torch.tensor([1, 1, 0, 1, 1], dtype=torch.bool))
    assert not torch.isnan(safe[0]).any() and not safe[1][2].any()


# ---- the faulted round against the reference --------------------------------

@pytest.fixture(scope="module")
def federation():
    """A 4-client IID split of adult, the reference's ``fedtgan``
    federation on it, and the port's states, encoders and tables carried
    over."""
    ds = jds.make_dataset("adult", n_rows=600, seed=5)
    parts = jds.partition_iid(ds, P, seed=5)
    fe = jax_setup(parts, ds.schema, CFG, seed=5, weighting="fedtgan")
    vgms = {j: {f: np.asarray(getattr(p, f))
                for f in ("weights", "means", "stds", "valid")}
            for j, p in fe.enc.vgms.items()}
    cats = {j: le.categories for j, le in fe.enc.label_encoders.items()}
    port_enc = interop.encoders_from_reference(ds.schema, vgms, cats,
                                               device="cpu")
    tables = [DeviceSampler(np.asarray(fe.tables.encoded[i]), port_enc,
                            "cpu").tables for i in range(P)]
    return ds, parts, fe, port_enc, tables


def _port_states(jstates):
    return [interop.gan_state_from_reference(
        _flatten(jax.tree.map(lambda x, i=i: x[i], jstates)), CFG,
        rng=_gen(i), device="cpu") for i in range(P)]


def _inject(fe, port_enc, tables, key):
    keys = jax.random.split(key, P)
    n_spans = tables[0].cum.shape[0]
    return dict(
        draws=[sampler_draws(keys[i], E * CFG.batch_size, n_spans)
               for i in range(P)],
        noise=[round_noise(fe.states.rng[i], CFG, port_enc.spans(),
                           CFG.batch_size, port_enc.encoded_dim, E)
               for i in range(P)])


CASES = {
    "neutral": (dict(), None),
    "nan": (dict(nan=[1]), None),
    "x50": (dict(scale={2: 50.0}), None),
    "all_masked": (dict(drop=[0, 1, 2, 3]), None),
    # norms ~[n, n, 3n, 6n]: the median of the two middle values (2n)
    # passes the 6n client at norm_mult 4, the lower one (n) drops it
    "even_cohort": (dict(scale={2: 3.0, 3: 6.0}), None),
    "edges": (dict(nan=[0], drop=[3]), 2),
}


def _slice(case):
    part = np.ones(P, bool)
    part[case.get("drop", [])] = False
    nan = np.zeros(P, bool)
    nan[case.get("nan", [])] = True
    scale = np.ones(P, np.float32)
    for c, s in case.get("scale", {}).items():
        scale[c] = s
    return part, nan, scale


@pytest.fixture(scope="module")
def jax_rounds(federation):
    """The reference's jitted ``faulted_round`` and local rounds (the jnp
    merge, the default guard), compiled once per ``n_edges``."""
    fe = federation[2]
    built = {}

    def get(edges):
        if edges not in built:
            prog = JaxProgram(CFG, fe.spans, fe.cond_spans,
                              batch=CFG.batch_size, local_steps=E,
                              weighting="fedtgan",
                              guard=jfaults.UpdateGuard(), n_edges=edges,
                              use_pallas=False)
            built[edges] = (jax.jit(prog.faulted_round),
                            jax.jit(prog._clients))
        return built[edges]
    return get


@pytest.mark.parametrize("name", sorted(CASES))
def test_faulted_round_matches_reference(federation, jax_rounds, name):
    """One faulted round from the reference's federation, every client's
    draws injected: the guard's decisions, the effective weights, the
    update norms and the merged model; one merge launch per tier."""
    ds, parts, fe, port_enc, tables = federation
    case, edges = CASES[name]
    part, nan, scale = _slice(case)
    faulted_round, clients = jax_rounds(edges)
    key = jax.random.PRNGKey(21)
    w = jax_weights("fedtgan", fe.S, fe.n_rows)
    jst, jm = faulted_round(
        fe.states, fe.tables, w, key,
        jfaults.FaultPlan(jnp.asarray(part), jnp.asarray(nan),
                          jnp.asarray(scale)))
    prog = FederatedProgram(CFG, port_enc.spans(), port_enc.condition_spans(),
                            batch=CFG.batch_size, local_steps=E,
                            weighting="fedtgan", guard=UpdateGuard(),
                            n_edges=edges)
    states = _port_states(fe.states)
    before = [t.clone() for t in states[0].params()]
    pw = resolve_weights("fedtgan", torch.from_numpy(np.array(fe.S)),
                         torch.from_numpy(np.array(fe.n_rows)))
    fault = FaultPlan(*(torch.from_numpy(a) for a in (part, nan, scale)))
    with ops.dispatch_scope() as d:
        states, m = prog.faulted_round(states, tables, pw, fault,
                                       **_inject(fe, port_enc, tables, key))
    assert dict(d)["weighted_agg_ref"] == (1 if edges is None else 2)
    for k in ("client_ok", "client_suspect", "merged"):
        np.testing.assert_array_equal(_np(m[k]), np.asarray(jm[k]),
                                      err_msg=k)
    np.testing.assert_allclose(_np(m["w_eff"]), np.asarray(jm["w_eff"]),
                               rtol=1e-5, atol=1e-12)
    # the norms of the transmitted deltas: by the triangle inequality they
    # differ by at most |scale| x the distance between the two packages'
    # local-round results (Adam's lr-sized steps on rounding-level
    # gradients, the round tolerance), plus float32 rounding
    jlocal, _ = clients(fe.states, fe.tables, key)
    local = _port_states(fe.states)
    prog.clients(local, tables, **_inject(fe, port_enc, tables, key))
    gap = np.array([np.sqrt(sum(
        float(np.sum((_np(a) - _np(b)) ** 2)) for a, b in zip(
            local[i].params(), interop.gan_state_from_reference(
                _flatten(jax.tree.map(lambda x, i=i: x[i], jlocal)), CFG,
                device="cpu").params()))) for i in range(P)])
    jn = np.asarray(jm["update_norm"])
    assert (np.abs(_np(m["update_norm"]) - jn)
            <= np.abs(scale) * gap + 1e-6 * jn + 1e-12).all()
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(_np(m[k]), np.asarray(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for st in states[1:]:
        assert all(torch.equal(a, b) for a, b in zip(states[0].params(),
                                                     st.params()))
    theirs = interop.gan_state_from_reference(
        _flatten(jax.tree.map(lambda x: x[0], jst)), CFG, device="cpu")
    # the merge adds w_eff_p * scale_p times each survivor's delta: the
    # round tolerance grows with the largest surviving scale
    amp = max(1.0, float(np.max(np.where(_np(m["client_ok"]), scale, 0))))
    diff = []
    for a, b in zip(states[0].params(), theirs.params(), strict=True):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                   atol=CFG.lr * E * amp)
        diff.append(np.abs(_np(a) - _np(b)).ravel())
    assert np.mean(np.concatenate(diff) <= 2e-6) >= 0.99
    if name == "all_masked":
        assert not bool(m["merged"])
        for a, b in zip(states[0].params(), before):
            assert torch.equal(a, b)
    if name == "neutral":          # the dense round, bit for bit
        dense = _port_states(fe.states)
        prog.weighted_round(dense, tables, pw,
                            **_inject(fe, port_enc, tables, key))
        for a, b in zip(states[0].params(), dense[0].params()):
            assert torch.equal(a, b)
    if name == "even_cohort":
        assert bool(m["client_ok"].all())
        norms = _np(m["update_norm"])
        lower = float(torch.nanmedian(m["update_norm"]))
        assert norms[3] > 4 * lower      # torch's lower median would drop it


def test_run_faulted_one_launch_per_round(federation):
    """A composed chaos plan over 3 rounds through ``run_faulted``: one
    merge launch per round, finite merged states, clients equal."""
    _, _, fe, port_enc, tables = federation
    prog = FederatedProgram(CFG, port_enc.spans(), port_enc.condition_spans(),
                            batch=CFG.batch_size, local_steps=E,
                            weighting="fedtgan", guard=UpdateGuard(),
                            participation=0.75)
    plan = compose(dropout_uniform(_gen(1), 3, P, rate=0.3),
                   corrupt_nans(_gen(2), 3, P, n_corrupt=1),
                   byzantine_scale(_gen(3), 3, P, n_byzantine=1))
    states = _port_states(fe.states)
    with pytest.raises(ValueError, match="generator per round"):
        prog.run_faulted(states, tables, torch.tensor(np.array(fe.S)),
                         torch.tensor(np.array(fe.n_rows)), plan)
    with ops.dispatch_scope() as d:
        states, m = prog.run_faulted(
            states, tables, torch.tensor(np.array(fe.S)),
            torch.tensor(np.array(fe.n_rows)), plan,
            generators=[_gen(10 + r) for r in range(3)])
    assert dict(d)["weighted_agg_ref"] == 3
    assert m["client_ok"].shape == (3, P) and m["merged"].shape == (3,)
    assert not (m["client_ok"] & plan.nan_mask).any()
    assert all(bool(torch.isfinite(t).all()) for t in states[0].params())


# ---- participation and FedProx ----------------------------------------------

def test_participation_rates_have_no_client_zero_bias():
    """Tied weights, fraction 0.5, 8 clients: per-client rates pass a
    chi-squared test (7 dof, p = 0.001: 24.32) against ``fraction`` plus
    the rescue's share, and client 0 is not pinned at 1."""
    Pc, n, frac = 8, 4000, 0.5
    w = torch.full((Pc,), 1.0 / Pc)
    g = _gen(0)
    masks = torch.stack([sample_participation(w, frac, generator=g)
                         for _ in range(n)])
    counts = masks.sum(0).numpy().astype(float)
    expected = n * (frac + (1 - frac) ** Pc / Pc)
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 24.32, (chi2, counts / n)
    assert counts.max() / n < 0.75


def test_participation_rescue_fires_only_on_an_empty_draw():
    """The draw is ``rand(P) < fraction`` then one rescue index: where the
    keep draw has a client it is the cohort; an empty one gets exactly one
    client, not always the same."""
    w = torch.tensor([0.1, 0.2, 0.3, 0.4])
    rescued = set()
    for seed in range(400):
        out = sample_participation(w, 0.05, generator=_gen(seed))
        keep = torch.rand(4, generator=_gen(seed)) < 0.05
        if keep.any():
            assert torch.equal(out, keep)
        else:
            assert int(out.sum()) == 1
            rescued.add(int(torch.argmax(out.int())))
    assert rescued == {0, 1, 2, 3}
    assert bool(sample_participation(w, 1.0, generator=_gen(0)).all())
    cw = sample_client_weights(w, 0.5, generator=_gen(1))
    assert abs(float(cw.sum()) - 1.0) < 1e-6
    np.testing.assert_array_equal(
        _np(cw > 0), _np(sample_participation(w, 0.5, generator=_gen(1))))


def test_fedprox_step_matches_reference(federation):
    """One FedProx-wrapped step from client 0's state toward other global
    parameters (the state's own, shifted), as the reference's
    ``fedprox_wrap`` takes it."""
    _, _, fe, port_enc, _ = federation
    mu = 0.3
    j0 = jax.tree.map(lambda x: x[0], fe.states)
    jstep = jtrainer.make_train_steps(CFG, fe.spans, fe.cond_spans)
    jb = jdraw(jax.tree.map(lambda a: a[0], fe.tables), jax.random.PRNGKey(3),
               CFG.batch_size, fe.enc.cond_dim)
    anchor = jax.tree.map(lambda x: x + 0.05, _gan_lens(j0))
    prox = jax.jit(jfedavg.fedprox_wrap(jstep, mu, lens=_gan_lens,
                                        merge=_gan_merge))
    jnew, jm = prox(j0, (jb, anchor))
    port = interop.gan_state_from_reference(_flatten(j0), CFG, device="cpu")
    glob = [t.detach() + 0.05 for t in port.params()]
    step = fedprox_wrap(make_train_steps(CFG, port_enc.spans(),
                                         port_enc.condition_spans()), mu)
    noise, _ = step_noise(j0.rng, CFG, port_enc.spans(), CFG.batch_size,
                          port_enc.encoded_dim)
    batch = tuple(torch.from_numpy(np.array(a)) for a in jb)
    m = step(port, (batch, glob), noise)
    np.testing.assert_allclose(float(m["g_loss"]), float(jm["g_loss"]),
                               rtol=1e-4, atol=1e-6)
    theirs = interop.gan_state_from_reference(_flatten(jnew), CFG,
                                              device="cpu")
    diff = []
    for a, b in zip(port.params(), theirs.params(), strict=True):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=CFG.lr)
        diff.append(np.abs(_np(a) - _np(b)).ravel())
    assert np.mean(np.concatenate(diff) <= 2e-6) >= 0.99
    # the pull moved every parameter toward the anchor by mu of the gap
    plain = interop.gan_state_from_reference(_flatten(j0), CFG, device="cpu")
    make_train_steps(CFG, port_enc.spans(), port_enc.condition_spans())(
        plain, batch, noise)
    for a, p, g in zip(port.params(), plain.params(), glob):
        torch.testing.assert_close(a, p - mu * (p - g), rtol=0, atol=0)


# ---- checkpoints across the packages ---------------------------------------

def test_port_checkpoint_reads_in_the_reference(federation, tmp_path):
    _, _, fe, _, _ = federation
    states = _port_states(fe.states)
    for st in states:                    # move off the initial values
        st.step, st.g_opt = 7, st.g_opt._replace(count=7)
        with torch.no_grad():
            st.gen.out.bias.add_(0.5)
            st.d_opt.mu[0].add_(0.25)
    blocked = np.array([0, 1, 0, 0], bool)
    path = save_fed_checkpoint(str(tmp_path), 3, states, blocked)
    assert os.path.basename(path) == "ckpt_00000003.npz"
    assert os.path.exists(str(tmp_path / "ckpt_00000003.json"))
    assert not any(f.endswith(".tmp.npz") for f in os.listdir(tmp_path))
    step, jst, jblocked = jax_restore(str(tmp_path), fe.states, P)
    assert step == 3
    np.testing.assert_array_equal(jblocked, blocked)
    for i in range(P):
        back = interop.gan_state_from_reference(
            _flatten(jax.tree.map(lambda x, i=i: x[i], jst)), CFG,
            device="cpu")
        assert (back.step, back.g_opt.count) == (7, 7)
        for a, b in zip(states[i].params(), back.params()):
            assert torch.equal(a, b)
        for a, b in zip(states[i].d_opt.mu + states[i].g_opt.nu,
                        back.d_opt.mu + back.g_opt.nu):
            assert torch.equal(a, b)
    rng = np.asarray(jst.rng)
    assert rng.dtype == np.uint32 and len({tuple(r) for r in rng}) == P


def test_reference_checkpoint_reads_in_the_port(federation, tmp_path):
    """A reference-written file of moved-on states (parameters, moments,
    counts and steps off their initial values): the port restores them
    and the blocklist; its generators are the ones it had (the file
    holds no torch stream)."""
    _, _, fe, _, _ = federation
    rng = np.random.default_rng(9)
    jst = jax.tree.map(
        lambda x: x + rng.normal(size=x.shape).astype(x.dtype)
        if x.dtype == jnp.float32 else x + E, fe.states)
    jst = jst._replace(rng=fe.states.rng)
    jax_save(str(tmp_path), 5, jst, np.array([1, 0, 0, 1], bool))
    states = _port_states(fe.states)
    rng_before = [s.rng.get_state() for s in states]
    step, states, blocked = restore_fed_checkpoint(str(tmp_path), states, P)
    assert step == 5 == latest_step(str(tmp_path))
    np.testing.assert_array_equal(blocked, [1, 0, 0, 1])
    for i, st in enumerate(states):
        want = interop.gan_state_from_reference(
            _flatten(jax.tree.map(lambda x, i=i: x[i], jst)), CFG,
            device="cpu")
        assert (st.step, st.g_opt.count, st.d_opt.count) == (E, E, E)
        for a, b in zip(st.params(), want.params()):
            assert torch.equal(a, b)
        for ours, theirs in ((st.g_opt, want.g_opt), (st.d_opt, want.d_opt)):
            for a, b in zip(ours.mu + ours.nu, theirs.mu + theirs.nu):
                assert torch.equal(a, b)
        assert torch.equal(st.rng.get_state(), rng_before[i])


# ---- run_federated's degraded mode ------------------------------------------

@pytest.fixture(scope="module")
def small():
    ds = jds.make_dataset("adult", n_rows=320, seed=6)
    return ds, jds.partition_iid(ds, P, seed=6)


def _chaos(rounds):
    return compose(dropout_uniform(_gen(7), rounds, P, rate=0.3),
                   corrupt_nans(_gen(8), rounds, P, n_corrupt=1),
                   byzantine_scale(_gen(9), rounds, P, n_byzantine=1,
                                   scale=64.0))


def _gen_params(res):
    return [t.detach().clone() for t in res.final_g_params.parameters()]


def test_resume_is_bit_exact(small, tmp_path):
    """Kill after the first stretch, resume from its checkpoint: the final
    generator equals the uninterrupted run's, and so do the history's
    reports.  Participation, FedProx and a chaos plan draw on the way."""
    ds, parts = small
    kw = dict(cfg=CFG, rounds=4, local_steps=2, seed=0, faults=_chaos(4),
              participation=0.8, fedprox_mu=0.01, eval_real=ds.data,
              eval_every=2, eval_samples=64, device="cpu")
    d = str(tmp_path / "ckpt")
    full = run_federated(parts, ds.schema, ckpt_dir=d, **kw)
    assert latest_step(d) == 4
    for f in os.listdir(d):                       # "crash" after round 2
        if "00000004" in f:
            os.remove(os.path.join(d, f))
    with np.load(os.path.join(d, "ckpt_00000002.npz")) as z:
        assert TORCH_RNG_KEY in z.files
    resumed = run_federated(parts, ds.schema, ckpt_dir=d, resume=True, **kw)
    for a, b in zip(_gen_params(full), _gen_params(resumed)):
        assert torch.equal(a, b)
    assert resumed.history[-1]["avg_jsd"] == full.history[-1]["avg_jsd"]
    assert [h["round"] for h in resumed.history] == [4]


def test_retry_blocks_the_first_suspect_round(small):
    """Guard off: client 2's NaN poisons the 3-round stretch from its
    first round on (every later round flags everyone); the retry restores
    the stretch's start, blocks client 2 alone, and ends finite.  With no
    retry budget the run raises."""
    ds, parts = small
    plan = corrupt_nans(_gen(3), 3, P, clients=[2])
    kw = dict(cfg=CFG, rounds=3, local_steps=2, seed=0, faults=plan,
              guard=None, device="cpu")
    seen = []
    res = run_federated(parts, ds.schema,
                        on_round=lambda r, s, m: seen.append(
                            _np(m["client_suspect"])), **kw)
    assert res.retries == 1
    np.testing.assert_array_equal(res.blocked, [0, 0, 1, 0])
    np.testing.assert_array_equal(seen[0], [0, 0, 1, 0])
    assert seen[1].all()                     # poisoned: everyone suspect
    assert all(bool(torch.isfinite(t).all()) for t in _gen_params(res))
    with pytest.raises(PoisonedRunError, match="retry budget"):
        run_federated(parts, ds.schema, max_retries=0, **kw)


def test_plan_checks(small):
    ds, parts = small
    with pytest.raises(ValueError, match="FaultPlan"):
        run_federated(parts, ds.schema, cfg=CFG, rounds=2, faults=no_faults(3, P),
                      device="cpu")
    dead = no_faults(2, P)._replace(participate=torch.zeros((2, P), dtype=torch.bool))
    with pytest.raises(NoSurvivingClients):
        run_federated(parts, ds.schema, cfg=CFG, rounds=2, faults=dead,
                      device="cpu")
    with pytest.raises(ValueError, match="edges"):
        run_federated(parts, ds.schema, cfg=CFG, rounds=1, program="host",
                      edges=2, device="cpu")
    with pytest.raises(ValueError, match="participation"):
        run_federated(parts, ds.schema, cfg=CFG, rounds=1, participation=0.0,
                      device="cpu")


@pytest.mark.parametrize("faulted", [False, True])
def test_host_oracle_agrees_with_the_fused_program(small, faulted):
    """One round through ``program="host"`` (per-leaf merge, no kernel)
    and ``program="fed"`` (one fused merge) at the same seed: the same
    local rounds, the merges within their tolerance; under a chaos plan
    with participation, the same survivors."""
    ds, parts = small
    kw = dict(cfg=CFG, rounds=1, local_steps=2, seed=1, device="cpu")
    if faulted:
        kw.update(faults=_chaos(1), participation=0.8)
    out = {}
    for program in ("fed", "host"):
        oks = []
        with ops.dispatch_scope() as d:
            res = run_federated(parts, ds.schema, program=program,
                                on_round=lambda r, s, m: oks.append(
                                    _np(m.get("client_ok", torch.ones(1)))),
                                **kw)
        out[program] = (_gen_params(res), oks, dict(d))
    assert out["fed"][2]["weighted_agg_ref"] == 1
    assert ops.stage_dispatches(out["host"][2], "weighted_agg") == 0
    np.testing.assert_array_equal(out["fed"][1], out["host"][1])
    for a, b in zip(out["fed"][0], out["host"][0]):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)
