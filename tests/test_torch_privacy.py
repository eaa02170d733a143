"""The port's privacy layer held against the JAX package on the CPU: round
traces interchangeable with the reference's ``.npz`` files, traced runs
bit-identical to untraced ones, the attacks replayed on one
reference-recorded victim trace, and DP's effect on the port's own
victims.

The reference records the victim (2 clients of 20 ``adult`` rows, the
overfitting configuration of ``tests/test_privacy.py``); its encoders are
carried over with ``repro_torch.interop`` and its Gumbel draws for the
attacks' encodes (``plan._draw_gumbel(PRNGKey(0), n)``, its default key)
are injected.

Tolerances:
  * traces: bit-exact (``RoundTrace.equals``: values and dtypes).
  * critic scores: rtol = atol = 1e-5 (float32 matrix products summed in
    another order).
  * AUCs: 1e-6, plus 1/(n_m n_h) for every (member, holdout) pair whose
    reference scores lie within 2e-5 of each other: such a pair can
    order either way under the scores' tolerance (a float32 tie in the
    reference, 1 ulp apart in the port, moves an AUC by 1/(2 n_m n_h)).
  * probe reconstruction, setup marginals, VGM moments: equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import privacy as jpriv  # noqa: E402
from repro.core.architectures import run_federated as jrun  # noqa: E402
from repro.fed import setup_federation as jsetup  # noqa: E402
from repro.gan.ctgan import CTGANConfig as JConfig  # noqa: E402
from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro.tabular import make_dataset, partition_iid  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import privacy  # noqa: E402
from repro_torch.core.architectures import run_federated  # noqa: E402
from repro_torch.fed import no_faults, setup_federation  # noqa: E402
from repro_torch.gan.ctgan import CTGANConfig  # noqa: E402
from repro_torch.gan.dp import DPConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.privacy import RoundTrace, TraceError  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

KW = dict(batch_size=8, gen_hidden=(32,), disc_hidden=(32,), pac=4, z_dim=8)
CFG, JCFG = CTGANConfig(**KW), JConfig(**KW)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread, as ``tests/test_torch_degraded.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def victim():
    """The reference's recorded victim, the holdout pool, and the port's
    copy of the victim's encoders."""
    ds = make_dataset("adult", n_rows=40, seed=0)
    parts = partition_iid(ds, 2, seed=0)
    pool = make_dataset("adult", n_rows=400, seed=100).data
    jtr = jpriv.RoundTrace()
    res = jrun(parts, ds.schema, cfg=JCFG, rounds=3, local_steps=5, seed=0,
               weighting="uniform", trace=jtr)
    enc = res.encoders
    vgms = {j: {f: np.asarray(getattr(p, f))
                for f in ("weights", "means", "stds", "valid")}
            for j, p in enc.vgms.items()}
    cats = {j: le.categories for j, le in enc.label_encoders.items()}
    port_enc = interop.encoders_from_reference(ds.schema, vgms, cats,
                                               device="cpu")
    plan = enc.plan()

    def gumbel(n):
        return torch.from_numpy(np.array(plan._draw_gumbel(
            jax.random.PRNGKey(0), n)))
    return ds, parts, pool, jtr, enc, port_enc, gumbel


def _port_run(parts, schema, **kw):
    tr = RoundTrace()
    res = run_federated(parts, schema, cfg=CFG, seed=0, weighting="uniform",
                        trace=tr, device="cpu", **kw)
    return tr, res


# ---- traces ---------------------------------------------------------------------

def test_reference_trace_loads_in_the_port(victim, tmp_path):
    _, _, _, jtr, _, _, _ = victim
    path = str(tmp_path / "ref.npz")
    jtr.save(path)
    tr = RoundTrace.load(path)
    assert tr.rounds == jtr.rounds == [0, 1, 2] and tr.meta == jtr.meta
    for a, b in zip(tr.updates, jtr.updates):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_array_equal(tr.global_before(1), jtr.global_before(1))
    again = str(tmp_path / "again.npz")
    tr.save(again)
    assert RoundTrace.load(again).equals(tr)
    with np.load(path) as z, np.load(again) as y:
        assert sorted(z.files) == sorted(y.files)


def test_port_trace_loads_in_the_reference(victim, tmp_path):
    ds, parts = victim[:2]
    tr, _ = _port_run(parts, ds.schema, rounds=2, local_steps=2)
    assert tr.meta == {"weighting": "uniform", "P": 2, "program": "fed",
                       "seed": 0, "dp": False}
    path = str(tmp_path / "port.npz")
    tr.save(path)
    back = jpriv.RoundTrace.load(path)
    assert back.rounds == tr.rounds and back.meta == tr.meta
    for name in ("weights", "n_rows", "global0"):
        a, b = getattr(back, name), getattr(tr, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for a, b in zip(back.updates, tr.updates):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for field in RoundTrace._DICT_FIELDS:
        assert sorted(getattr(back, field)) == sorted(getattr(tr, field))
    assert RoundTrace.load(path).equals(tr)


def test_global0_is_the_references_from_its_initial_state(victim):
    """The port's federation carrying the reference's initial states
    records ``global0`` bit-equal to the reference's, and the same §4.1
    category frequencies."""
    ds, parts = victim[:2]
    jfe = jsetup(parts, ds.schema, JCFG, 0, "uniform")
    jtr = jpriv.RoundTrace().record_setup(jfe)
    fe = setup_federation(parts, ds.schema, CFG, 0, "uniform", device="cpu")
    fe.states = [interop.gan_state_from_reference(
        _flatten(jax.tree.map(lambda x, i=i: x[i], jfe.states)), CFG,
        device="cpu") for i in range(2)]
    tr = RoundTrace().record_setup(fe)
    assert tr.global0.dtype == jtr.global0.dtype == np.float32
    np.testing.assert_array_equal(tr.global0, jtr.global0)
    assert sorted(tr.cat_freqs) == sorted(jtr.cat_freqs)
    for j in tr.cat_freqs:
        np.testing.assert_array_equal(tr.cat_freqs[j], jtr.cat_freqs[j])
    assert sorted(tr.vgm_means) == sorted(jtr.vgm_means)


@pytest.mark.parametrize("program", ["fed", "host"])
def test_traced_runs_are_bit_identical_to_untraced(victim, program):
    """A traced run ends with the untraced run's generator, bit for bit;
    the round's recorded stack is the merge input mapped to the
    reference's layout; the fed program merges once a round."""
    ds, parts = victim[:2]
    kw = dict(cfg=CFG, rounds=2, local_steps=1, seed=1, program=program,
              weighting="uniform", device="cpu")
    seen = []
    tr = RoundTrace()
    with ops.dispatch_scope() as d:
        traced = run_federated(parts, ds.schema, trace=tr, on_round=lambda
                               r, st, m: seen.append([t.detach().clone() for
                                                      t in st[0].params()]),
                               **kw)
    plain = run_federated(parts, ds.schema, **kw)
    for a, b in zip(traced.final_g_params.parameters(),
                    plain.final_g_params.parameters()):
        assert torch.equal(a, b)
    assert ops.stage_dispatches(d, "weighted_agg") == (2 if program == "fed"
                                                       else 0)
    assert tr.meta["program"] == program and tr.n_rounds == 2
    # the round-1 broadcast, rebuilt from the trace, is the merged model
    g = privacy.global_params(tr, CFG, traced.encoders, index=1)
    for a, b in zip(list(g["g"].parameters()) + list(g["d"].parameters()),
                    seen[0]):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_trace_refuses_the_degraded_path_and_bad_input(victim, tmp_path):
    ds, parts = victim[:2]
    for kw in (dict(participation=0.5), dict(faults=no_faults(1, 2))):
        with pytest.raises(ValueError, match="faults"):
            _port_run(parts, ds.schema, rounds=1, **kw)
    tr = RoundTrace()
    with pytest.raises(TraceError):
        tr.update_stack()
    with pytest.raises(TraceError):
        tr.record_round(0, np.zeros(3))
    tr.record_round(0, np.zeros((2, 4)))
    with pytest.raises(TraceError):
        tr.record_round(1, np.zeros((3, 4)))
    with pytest.raises(TraceError):
        tr.global_before(0)
    with pytest.raises(TraceError):
        tr.global_before(1)
    path = str(tmp_path / "t.npz")
    np.savez(path, rogue=np.zeros(3))
    with pytest.raises(TraceError):
        RoundTrace.load(path)


# ---- the attacks on the reference's victim ----------------------------------------

def _near_pairs(m, h, within=2e-5):
    """(member, holdout) pairs whose scores lie within ``within``."""
    return int((np.abs(m[:, None] - h[None, :]) <= within).sum())


def _auc_close(got, want, m, h):
    """|got - want| <= 1e-6 plus one pair's share of the AUC for every pair
    whose order the scores' 1e-5 tolerance could swap; that share must stay
    at most 1e-2, or the bound would pass any AUC."""
    share = _near_pairs(m, h) / (len(m) * len(h))
    assert share <= 1e-2, f"{share} of the pairs lie within 2e-5"
    assert abs(got - want) <= 1e-6 + share, (got, want, share)


def test_discriminator_scores_match_reference(victim):
    _, parts, pool, jtr, enc, port_enc, gumbel = victim
    jd = jpriv.client_params(jtr, JCFG, enc, client=0)["d"]
    d = privacy.client_params(jtr, CFG, port_enc, client=0)["d"]
    rows = pool[:200]
    want = np.asarray(jpriv.discriminator_scores(jd, rows, enc, JCFG))
    with ops.dispatch_scope() as n:
        got = privacy.discriminator_scores(d, rows, port_enc, CFG,
                                           gumbel=gumbel(len(rows)))
    assert dict(n) == {"vgm_encode_table_ref": 1}
    assert got.shape == want.shape == (len(rows),)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_membership_attacks_match_reference(victim):
    """The loss-threshold, null and shadow AUCs on the reference's trace."""
    _, parts, pool, jtr, enc, port_enc, gumbel = victim
    hold = pool[:200]            # two row counts: 20 and 200
    want = jpriv.loss_threshold_mia(jtr, JCFG, enc, parts[0], hold)
    got = privacy.loss_threshold_mia(jtr, CFG, port_enc, parts[0], hold,
                                     encode_gumbel=gumbel)
    assert got["rounds_used"] == want["rounds_used"] == [0, 1, 2]
    for k in ("member_scores", "holdout_scores"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
    _auc_close(got["auc"], want["auc"], want["member_scores"],
               want["holdout_scores"])
    null_want = jpriv.loss_threshold_mia(jtr, JCFG, enc, pool[:200],
                                         pool[200:])
    _auc_close(privacy.null_auc(jtr, CFG, port_enc, pool,
                                encode_gumbel=gumbel),
               jpriv.null_auc(jtr, JCFG, enc, pool),
               null_want["member_scores"], null_want["holdout_scores"])
    sw = jpriv.shadow_model_mia(jtr, JCFG, enc, parts[0], pool[:200],
                                pool[200:])
    sg = privacy.shadow_model_mia(jtr, CFG, port_enc, parts[0], pool[:200],
                                  pool[200:], encode_gumbel=gumbel)
    _auc_close(sg["auc"], sw["auc"], sw["member_z"], sw["holdout_z"])
    assert sg["accuracy"] == pytest.approx(sw["accuracy"], abs=1e-6)
    assert sg["threshold"] == pytest.approx(sw["threshold"], rel=1e-5,
                                            abs=1e-6)
    with pytest.raises(privacy.AttackError, match="at least 4"):
        privacy.null_auc(jtr, CFG, port_enc, pool[:3])


def test_leakage_attacks_match_reference(victim):
    """Probe reconstruction, the setup marginals and VGM moments, the
    first-layer energy, and the one-call report."""
    _, _, _, jtr, enc, port_enc, _ = victim
    want = jpriv.dominant_category_hits(jtr, JCFG, enc)
    got = privacy.dominant_category_hits(jtr, CFG, port_enc)
    assert got["hit_rate"] == want["hit_rate"]
    assert sorted(got["columns"]) == sorted(want["columns"])
    for j, col in want["columns"].items():
        np.testing.assert_array_equal(got["columns"][j]["predicted"],
                                      col["predicted"])
        np.testing.assert_array_equal(got["columns"][j]["true"], col["true"])
        np.testing.assert_allclose(got["columns"][j]["rel_scores"],
                                   col["rel_scores"], rtol=1e-5, atol=1e-5)
    for j in jtr.cat_freqs:
        np.testing.assert_array_equal(privacy.setup_marginals(jtr, j),
                                      jpriv.setup_marginals(jtr, j))
    for j in jtr.vgm_means:
        a, b = (privacy.vgm_client_moments(jtr, j),
                jpriv.vgm_client_moments(jtr, j))
        for k in ("mean", "std"):
            np.testing.assert_array_equal(a[k], b[k])
    j = sorted(jtr.cat_freqs)[0]
    np.testing.assert_allclose(
        privacy.category_update_energy(jtr, CFG, port_enc, column=j,
                                       client=1),
        jpriv.category_update_energy(jtr, JCFG, enc, column=j, client=1),
        rtol=1e-5, atol=1e-9)
    rep = privacy.leakage_report(jtr, CFG, port_enc, client=1)
    assert set(rep) == {"client", "update", "setup_marginals",
                        "setup_moments"}
    assert rep["update"]["hit_rate"] == want["hit_rate"]
    with pytest.raises(privacy.AttackError):
        privacy.setup_marginals(jtr, 10_000)
    with pytest.raises(privacy.AttackError):
        privacy.client_params(jtr, CFG, port_enc, client=5)
    assert privacy.attack_auc([1, 2, 3], [-1, -2, -3]) == 1.0
    assert privacy.attack_auc([0, 0], [0, 0]) == 0.5
    assert privacy.attack_auc([-5], [5]) == 0.0


# ---- DP on the port's own victims ---------------------------------------------------

def test_dp_shrinks_the_membership_leak(victim):
    """The port's own victim (20 local steps a round for 6 rounds, so
    that it overfits) leaks membership; the same run with DP (noise
    multiplier 2) leaks less.  The excess AUC is averaged over both
    clients (each client's 20 members against the 400-row pool), as one
    client's AUC at 20 members has a standard error of ~0.066."""
    ds, parts, pool = victim[:3]

    def excess(dp):
        tr, res = _port_run(parts, ds.schema, rounds=6, local_steps=20,
                            dp=dp)
        return np.mean([privacy.loss_threshold_mia(
            tr, CFG, res.encoders, parts[c], pool, client=c)["auc"] - 0.5
            for c in (0, 1)]), res
    raw, res_raw = excess(None)
    private, res_dp = excess(DPConfig(noise_mult=2.0))
    assert raw > 0.0
    assert abs(private) < raw, (raw, private)
    assert res_raw.epsilon is None
    assert res_dp.epsilon == pytest.approx(
        DPConfig(noise_mult=2.0).epsilon(120, CFG.batch_size, 20))
