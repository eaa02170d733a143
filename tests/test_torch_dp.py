"""The port's differentially private training held against the JAX package
on the CPU: ``DPConfig`` / ``dp_epsilon`` / ``make_dp_train_steps``'s
estimates and rejections, the clip and the noise, one DP step, DP rounds
through the federated program, and the LM's client-level DP merge.

The same numpy-seeded inputs go through both packages; the reference's
random draws are reproduced from its key splits
(``tests/torch_jax_draws.py:dp_step_noise``) and injected; state is
carried over with ``repro_torch.interop``.  TF32 is off.

Tolerances:
  * epsilon: rel 1e-12 (the same float64 formula); rejections: the same
    exception type and message.
  * ``clip_params`` against ``_clip_tree``: atol 1e-6 (the global norm's
    float32 sum runs over the tensors in another order).
  * ``noise_params``: the sum of squares over sigma^2 inside the
    chi-squared band [ppf(1e-6), ppf(1 - 1e-6)] of its degrees of freedom.
  * one DP step: metrics, critic and generator parameters and Adam
    moments rtol 1e-5, atol 1e-6 (the per-pack sums are float32 in another
    order).  The step starts from Adam moments away from zero, as after a
    few steps, so that a gradient zero up to rounding makes a step of
    rounding size, not of lr (``tests/test_torch_train.py`` explains the
    lr-sized steps from zero moments).
  * DP rounds, host oracle against the fused program: the merge
    tolerance of ``tests/test_torch_degraded.py`` (rtol 1e-6, atol 1e-7).
  * the LM's DP merge against the reference's ``one_round(dp=)``: atol
    1e-6 (float32 sums in another order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from scipy import stats  # noqa: E402

from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.gan import ctgan as jctgan  # noqa: E402
from repro.gan import dp as jdp  # noqa: E402
from repro.gan import trainer as jtrainer  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import Transformer as JTransformer  # noqa: E402
from repro.models import TrainState as JTrainState  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.optim.optimizers import AdamState  # noqa: E402
from repro.synth import DeviceSampler as JaxDeviceSampler  # noqa: E402
from repro.synth import draw_batch as jax_draw_batch  # noqa: E402
from repro.tabular import datasets as jds  # noqa: E402
from repro.tabular import encoders as jenc  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.architectures import run_federated  # noqa: E402
from repro_torch.fed import (FederatedProgram, no_faults,  # noqa: E402
                             setup_federation)
from repro_torch.gan import dp  # noqa: E402
from repro_torch.gan.ctgan import CTGANConfig  # noqa: E402
from repro_torch.gan.trainer import init_gan_state  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import (Transformer, TrainState,  # noqa: E402
                                make_train_step, tree_items, tree_leaves)
from repro_torch.synth import DeviceSampler, RoundEngine  # noqa: E402
from torch_jax_draws import dp_step_noise  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

CFG = CTGANConfig(z_dim=8, gen_hidden=(16, 16), disc_hidden=(16, 16),
                  pac=2, batch_size=8)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _full_precision():
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread, as ``tests/test_torch_degraded.py``: the suite
    runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy()


# ---- the estimate and the rejections ----------------------------------------

_EPS = dict(steps=100, batch=50, n_rows=10_000, noise_mult=1.0, delta=1e-5)
CASES = [("dp_epsilon", dict(_EPS)),
         ("dp_epsilon", dict(_EPS, steps=100.0)),
         ("dp_epsilon", dict(_EPS, steps=4, batch=500, n_rows=8000,
                             noise_mult=0.3)),
         ("dp_epsilon", dict(_EPS, delta=1e-6, noise_mult=2.0))]
CASES += [("dp_epsilon", dict(_EPS, **kw)) for kw in (
    dict(steps=0), dict(steps=-3), dict(steps=1.5), dict(batch=0),
    dict(batch=-1), dict(n_rows=0), dict(batch=200, n_rows=100),
    dict(noise_mult=0.0), dict(noise_mult=-1.0),
    dict(noise_mult=float("inf")), dict(noise_mult=float("nan")),
    dict(delta=0.0), dict(delta=1.0), dict(delta=2.0))]
CASES += [("DPConfig", kw) for kw in (
    dict(), dict(noise_mult=2.0, delta=1e-6), dict(l2_clip=0.0),
    dict(l2_clip=-1.0), dict(l2_clip=float("inf")), dict(noise_mult=0.0),
    dict(noise_mult=float("nan")), dict(delta=0.0), dict(delta=1.0))]
CASES += [("make_dp_train_steps", kw) for kw in (
    dict(), dict(l2_clip=0.0), dict(noise_mult=0.0),
    dict(noise_mult=float("-inf")), dict(batch_size=10, pac=4))]


def _outcome(mod, cfg_cls, kind, kw):
    """("ok", epsilon or None) or (exception type name, message)."""
    try:
        if kind == "dp_epsilon":
            return "ok", mod.dp_epsilon(**kw)
        if kind == "DPConfig":
            return "ok", mod.DPConfig(**kw).epsilon(100, 50, 10_000)
        cfg_kw = {k: kw[k] for k in ("batch_size", "pac") if k in kw}
        dp_kw = {k: v for k, v in kw.items() if k not in cfg_kw}
        mod.make_dp_train_steps(cfg_cls(**cfg_kw), (), (), **dp_kw)
        return "ok", None
    except ValueError as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("kind,kw", CASES,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(CASES)])
def test_estimates_and_rejections_match_reference(kind, kw):
    want = _outcome(jdp, jctgan.CTGANConfig, kind, kw)
    got = _outcome(dp, CTGANConfig, kind, kw)
    assert got[0] == want[0]
    if got[0] == "ok" and want[1] is not None:
        assert got[1] == pytest.approx(want[1], rel=1e-12)
    else:
        assert got[1] == want[1]
    if got[0] != "ok":
        assert got[0] == "DPError"


# ---- clip and noise ---------------------------------------------------------------

@pytest.mark.parametrize("scale", [10.0, 1e-3])
def test_clip_params_matches_reference(scale):
    rng = np.random.default_rng(0)
    shapes = [(8, 8), (4,), (3, 5)]
    leaves = [(scale * rng.normal(size=s)).astype(np.float32) for s in shapes]
    want = jdp._clip_tree({f"k{i}": jnp.asarray(a) for i, a in
                           enumerate(leaves)}, 1.0)
    got = dp.clip_params([torch.from_numpy(a) for a in leaves], 1.0)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[f"k{i}"]),
                                   rtol=0, atol=1e-6)
    norm = float(torch.sqrt(sum(torch.sum(g * g) for g in got)))
    assert norm <= 1.0 + 1e-5
    if scale < 1:                                     # below: the identity
        for g, a in zip(got, leaves):
            np.testing.assert_allclose(g.numpy(), a, rtol=1e-6)
    # per pack through vmap: each row's norm is bounded separately
    packs = [torch.from_numpy((scale * rng.normal(size=(5, *s))).astype(
        np.float32)) for s in shapes]
    clipped = dp.clip_packs(packs, 0.5)
    norms = torch.sqrt(sum(torch.sum(c.reshape(5, -1) ** 2, dim=1)
                           for c in clipped))
    assert float(norms.max()) <= 0.5 * (1 + 1e-6)


@pytest.mark.parametrize("sigma", [0.05, 1.0, 20.0])
def test_noise_params_chi_squared(sigma):
    zeros = [torch.zeros(64, 32), torch.zeros(2048)]
    noisy = dp.noise_params(zeros, sigma,
                            generator=torch.Generator().manual_seed(3))
    n = 64 * 32 + 2048
    ss = sum(float(torch.sum(g.double() ** 2)) for g in noisy)
    lo, hi = stats.chi2.ppf([1e-6, 1 - 1e-6], df=n)
    assert lo <= ss / sigma ** 2 <= hi
    given = [torch.ones(3), torch.ones(2)]
    out = dp.noise_params([torch.zeros(3), torch.zeros(2)], 2.0, given)
    assert [o.tolist() for o in out] == [[2.0] * 3, [2.0] * 2]


# ---- one DP step --------------------------------------------------------------------

@pytest.fixture(scope="module")
def table():
    ds = jds.make_dataset("adult", n_rows=400, seed=2)
    key = jax.random.PRNGKey(2)
    enc = jenc.fit_centralized_encoders(ds.data, ds.schema, key)
    encoded = np.asarray(enc.encode(ds.data, key))
    vgms = {j: {f: np.asarray(getattr(p, f))
                for f in ("weights", "means", "stds", "valid")}
            for j, p in enc.vgms.items()}
    cats = {j: le.categories for j, le in enc.label_encoders.items()}
    port_enc = interop.encoders_from_reference(ds.schema, vgms, cats,
                                               device="cpu")
    jstate = jtrainer.init_gan_state(jax.random.PRNGKey(7), CFG,
                                     enc.cond_dim, enc.encoded_dim)
    # Adam moments away from their initial zeros, as after a few steps
    rng = np.random.default_rng(8)

    def moments(params):
        return AdamState(
            jax.tree.map(lambda p: jnp.asarray(
                1e-3 * rng.normal(size=p.shape), jnp.float32), params),
            jax.tree.map(lambda p: jnp.asarray(
                1e-6 * rng.random(size=p.shape), jnp.float32), params),
            jnp.asarray(3, jnp.int32))
    jstate = jstate._replace(g_opt=moments(jstate.g_params),
                             d_opt=moments(jstate.d_params),
                             step=jnp.asarray(3, jnp.int32))
    return enc, encoded, port_enc, jstate


def test_dp_step_matches_reference(table):
    """One DP step from a carried-over, once-trained state, fed the
    reference's draws (its 6-way split, per-pack keys, per-leaf Gaussians):
    metrics, parameters and moments of both networks."""
    enc, encoded, port_enc, jstate = table
    clip, noise_mult = 0.5, 1.0
    batch = jax_draw_batch(JaxDeviceSampler(encoded, enc).tables,
                           jax.random.PRNGKey(11), CFG.batch_size,
                           enc.cond_dim)
    jstep = jax.jit(jdp.make_dp_train_steps(
        CFG, enc.spans(), enc.condition_spans(), l2_clip=clip,
        noise_mult=noise_mult))
    jnew, jm = jstep(jstate, batch)

    port = interop.gan_state_from_reference(_flatten(jstate), CFG,
                                            device="cpu")
    noise, _ = dp_step_noise(jstate.rng, CFG, port_enc.spans(),
                             CFG.batch_size, port_enc.encoded_dim, port.disc)
    tb = tuple(torch.from_numpy(np.array(a)) for a in batch)
    # the clip is active: some pack's gradient is longer than it
    with torch.no_grad():
        fake_in = torch.cat([ops.segment_activations(
            port.gen(noise.z_d, tb[0]), port_enc.spans(), noise.u_d,
            CFG.tau), tb[0]], 1)
    grads, _ = dp.per_pack_critic_grads(port.disc, CFG,
                                        torch.cat([tb[2], tb[0]], 1),
                                        fake_in, noise)
    norms = torch.sqrt(sum(torch.sum(g.reshape(g.shape[0], -1) ** 2, 1)
                           for g in grads))
    assert norms.shape == (CFG.batch_size // CFG.pac,)
    assert float(norms.max()) > clip
    step = dp.make_dp_train_steps(CFG, port_enc.spans(),
                                  port_enc.condition_spans(), l2_clip=clip,
                                  noise_mult=noise_mult)
    with ops.dispatch_scope() as d:
        m = step(port, tb, noise)
    assert dict(d) == {"segment_activations_ref": 2}
    for k in ("d_loss", "g_loss", "wgan", "gp", "ce"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    want = interop.gan_state_from_reference(_flatten(jnew), CFG, device="cpu")
    assert port.step == want.step and port.d_opt.count == want.d_opt.count
    for a, b in zip(port.params() + port.d_opt.mu + port.d_opt.nu
                    + port.g_opt.mu + port.g_opt.nu,
                    want.params() + want.d_opt.mu + want.d_opt.nu
                    + want.g_opt.mu + want.g_opt.nu, strict=True):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)


def test_dp_step_draws_its_own_noise_and_batches_the_packs(table):
    """Without injected draws the step draws from the client's generator
    (the same seed gives the same state); the per-pack gradients come from
    one vmapped call whatever the pack count."""
    enc, encoded, port_enc, _ = table
    tables = DeviceSampler(encoded, port_enc, "cpu").tables
    engine = RoundEngine(CFG, port_enc.spans(), port_enc.condition_spans(),
                         batch=CFG.batch_size, local_steps=2,
                         dp=dp.DPConfig(noise_mult=1.0))

    def run(seed):
        st = init_gan_state(CFG, port_enc.cond_dim, port_enc.encoded_dim,
                            generator=torch.Generator().manual_seed(0),
                            rng=torch.Generator().manual_seed(seed),
                            device="cpu")
        _, m = engine.local_round(st, tables)
        assert all(bool(torch.isfinite(v).all()) for v in m.values())
        return st
    a, b, c = run(1), run(1), run(2)
    assert a.step == 2 and a.d_opt.count == 2
    assert torch.equal(a.disc.out.weight, b.disc.out.weight)
    assert not torch.equal(a.disc.out.weight, c.disc.out.weight)
    calls = []
    real_vmap = torch.func.vmap

    def counting(fn, *args, **kw):
        calls.append(fn)
        return real_vmap(fn, *args, **kw)
    torch.func.vmap = counting
    try:
        engine.local_round(a, tables)
    finally:
        torch.func.vmap = real_vmap
    assert len(calls) == 2 * 2           # per step: the gradients, the clip
    with pytest.raises(ValueError, match="step_fn or dp"):
        RoundEngine(CFG, port_enc.spans(), port_enc.condition_spans(),
                    batch=8, local_steps=1, step_fn=lambda s, b, n: {},
                    dp=dp.DPConfig())


# ---- DP rounds ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    ds = jds.make_dataset("adult", n_rows=160, seed=1)
    parts = jds.partition_iid(ds, 4, seed=1)
    return ds, parts, setup_federation(parts, ds.schema, CFG, 1, "uniform",
                                       device="cpu")


@pytest.mark.parametrize("form", ["flat", "faulted", "edges", "fedprox"])
def test_dp_round_keeps_its_merge_launches(small, form):
    """A DP round merges in ONE ``weighted_agg`` (two with edges), faulted
    or not, and FedProx wraps the DP step."""
    _, _, fe = small
    kw = {"edges": dict(n_edges=2), "fedprox": dict(fedprox_mu=0.1)}.get(
        form, {})
    prog = FederatedProgram(CFG, fe.spans, fe.cond_spans,
                            batch=CFG.batch_size, local_steps=1,
                            weighting="uniform", dp=dp.DPConfig(), **kw)
    states = [s.replica(torch.Generator().manual_seed(i))
              for i, s in enumerate(fe.states)]
    before = [t.clone() for t in states[0].params()]
    with ops.dispatch_scope() as d:
        if form == "faulted":
            plan = no_faults(1, 4)
            states, m = prog.faulted_round(
                states, fe.tables, fe.weights,
                type(plan)(*(x[0] for x in plan)))
            assert bool(m["client_ok"].all())
        else:
            states, m = prog.weighted_round(states, fe.tables, fe.weights)
    assert ops.stage_dispatches(d, "weighted_agg") == (2 if form == "edges"
                                                       else 1)
    assert m["d_loss"].shape == (4, 1)
    assert any(not torch.equal(a, b) for a, b in zip(states[0].params(),
                                                     before))
    for st in states[1:]:
        assert all(torch.equal(a, b) for a, b in zip(st.params(),
                                                     states[0].params()))


def test_dp_host_and_fed_rounds_agree(small):
    """``dp=`` through ``program="host"`` and ``"fed"`` at one seed: the
    same DP local rounds, merges within their tolerance; the reported
    epsilon is the reference's estimate at the smallest client; with
    ``client_chunk=2`` the fused run is the dense one, bit for bit."""
    ds, parts, _ = small
    cfg = dataclasses.replace(CFG, batch_size=8)
    conf = dp.DPConfig(noise_mult=1.5)
    out = {}
    for program in ("fed", "host"):
        res = run_federated(parts, ds.schema, cfg=cfg, rounds=2,
                            local_steps=2, seed=3, program=program, dp=conf,
                            device="cpu")
        out[program] = res
    for a, b in zip(out["fed"].final_g_params.parameters(),
                    out["host"].final_g_params.parameters()):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)
    n_min = min(len(p) for p in parts)
    want = jdp.DPConfig(noise_mult=1.5).epsilon(4, cfg.batch_size, n_min)
    assert out["fed"].epsilon == pytest.approx(want, rel=1e-12)
    assert out["host"].epsilon == out["fed"].epsilon
    big = dataclasses.replace(cfg, batch_size=n_min + 2)
    res = run_federated(parts, ds.schema, cfg=big, rounds=1, local_steps=1,
                        seed=3, dp=dp.DPConfig(), device="cpu")
    assert res.epsilon == float("inf")
    assert run_federated(parts, ds.schema, cfg=cfg, rounds=1,
                         device="cpu").epsilon is None
    # client_chunk, once refused, runs the DP rounds in chunks: the dense
    # DP run's generator bit for bit
    chunked = run_federated(parts, ds.schema, cfg=cfg, rounds=2,
                            local_steps=2, seed=3, program="fed", dp=conf,
                            client_chunk=2, device="cpu")
    for a, b in zip(out["fed"].final_g_params.parameters(),
                    chunked.final_g_params.parameters()):
        assert torch.equal(a, b)


# ---- the LM's client-level DP merge ---------------------------------------------

def test_lm_dp_merge_matches_reference():
    """The reference's ``one_round(dp=)`` (taken from its ``jax.jit``
    call) and the port's ``federated_round(dp=)`` on 2 clients of the
    float32 smollm-135m smoke config, lr 0 so that local training leaves
    the parameters where they start: client 0 at the initial parameters
    (the round's start), client 1 moved by a numpy-seeded offset longer
    than the clip, the reference's Gaussians injected.  The merged
    parameters agree within atol 1e-6; one ``weighted_agg`` launch."""
    arch, clients = "smollm-135m", 2
    jcfg = dataclasses.replace(jget_smoke(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    conf_j = jdp.DPConfig(l2_clip=0.5, noise_mult=0.7)
    conf = dp.DPConfig(l2_clip=0.5, noise_mult=0.7)
    kw = dict(clients=clients, rounds=1, local_steps=1, batch=1, seq=16,
              lr=0.0, seed=0, weighting="uniform")
    captured = {}
    real_jit = jax.jit

    def capture(fn, *a, **k):       # keep the compiled round to reuse
        captured[getattr(fn, "__name__", "")] = real_jit(fn, *a, **k)
        return captured[getattr(fn, "__name__", "")]
    jax.jit = capture
    try:
        jtrain.run_federated(jcfg, dp=conf_j, **kw)
    finally:
        jax.jit = real_jit
    one_round = captured["one_round"]

    p0 = JTransformer(jcfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    p1 = jax.tree.map(lambda x: x + jnp.asarray(
        0.01 * rng.normal(size=x.shape), jnp.float32), p0)
    opt = jopt.adam(0.0, b1=0.9, b2=0.95, max_grad_norm=1.0)
    jstates = JTrainState(
        jax.tree.map(lambda a, b: jnp.stack([a, b]), p0, p1),
        jax.tree.map(lambda x: jnp.stack([x, x]), opt.init(p0)),
        jnp.zeros((clients,), jnp.int32))
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (clients, 1, 1, 16),
                                             dtype=np.int32)
    rkey = jax.random.PRNGKey(42)
    jout, _ = one_round(jstates, jnp.asarray(toks), rkey)
    gauss = _flatten(jdp._noise_tree(jax.tree.map(jnp.zeros_like, p0), rkey,
                                     1.0))

    model = Transformer(cfg)
    topt = ttrain.lm_optimizer(0.0)
    states = []
    for p in (p0, p1):
        params = interop.lm_params_from_reference(_flatten(p), cfg,
                                                  device=CPU)
        states.append(TrainState(params, topt.init(tree_leaves(params)), 0))
    noise = []
    for path, leaf in tree_items(states[0].params):
        parts = path.split("/")
        a = (gauss["/".join(["layers"] + parts[2:])][int(parts[1])]
             if parts[0] == "layers" else gauss[path])
        noise.append(torch.from_numpy(np.asarray(a, np.float32)).reshape(-1))
    w = torch.full((clients,), 1.0 / clients)
    with ops.dispatch_scope() as d:
        ttrain.federated_round(states, make_train_step(model, topt),
                               [toks[i] for i in range(clients)],
                               w, dp=conf, dp_noise=torch.cat(noise))
    assert ops.stage_dispatches(d, "weighted_agg") == 1
    want = _flatten(jax.tree.map(lambda x: x[0], jout.params))
    for path, leaf in tree_items(states[1].params):
        parts = path.split("/")
        ref = (want["/".join(["layers"] + parts[2:])][int(parts[1])]
               if parts[0] == "layers" else want[path])
        np.testing.assert_allclose(_np(leaf), np.asarray(ref), rtol=0,
                                   atol=1e-6, err_msg=path)
    # the clip bit: client 1's delta was longer than the clip
    assert float(np.sqrt(sum(float(jnp.sum((a - b) ** 2)) for a, b in zip(
        jax.tree.leaves(p1), jax.tree.leaves(p0))))) > conf.l2_clip


def test_main_builds_the_dp_config(monkeypatch, capsys):
    """``--dp-noise`` hands ``run_federated`` a ``DPConfig`` of
    ``--dp-clip`` and the noise, and without ``--federated`` the run is
    the central one, the flag ignored, as in the reference."""
    seen = {}
    monkeypatch.setattr(ttrain, "run_federated",
                        lambda cfg, **kw: seen.setdefault("dp", kw["dp"]))
    ttrain.main(["--smoke", "--federated", "--dp-noise", "0.8", "--dp-clip",
                 "0.25", "--device", "cpu"])
    assert seen["dp"] == dp.DPConfig(l2_clip=0.25, noise_mult=0.8)
    ran = {}
    monkeypatch.setattr(ttrain, "run_centralized",
                        lambda cfg, **kw: ran.setdefault("kw", kw))
    ttrain.main(["--smoke", "--dp-noise", "1.0", "--steps", "1",
                 "--device", "cpu"])
    assert ran["kw"]["steps"] == 1
