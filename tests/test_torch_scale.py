"""The federation at scale and the presampled baseline, on the CPU: the
chunked client axis, ``tile_federation``, and the host sampler's draws,
``make_round_batches``, ``stack_sampler_tables`` and ``local_train_scan``
held against the JAX package.

Tolerances:
  * a chunked round equals the dense round bit for bit (states and
    metrics, dense, FedProx and faulted): the port runs the clients one at
    a time either way, in the same order.  The reference's own
    chunked-vs-dense checks are not used as an oracle (they fail under
    this container's jax).
  * the host sampler's draws, the presampled stacks and the padded
    sampler tables: equal to the reference's, exactly (numpy on both
    sides, the same seed).
  * tiled weights: rtol 1e-5 of the reference's ``resolve_weights`` on
    the tiled divergence matrix, as ``tests/test_torch_fed.py::
    test_weights_match_reference`` states.
  * ``local_train_scan`` with the reference's noise injected: as
    ``tests/test_torch_train.py`` states for a local round (losses rtol
    1e-4; moments atol 2e-6; parameters atol lr per step and 99% of
    their elements atol 2e-6).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro.fed.program import resolve_weights as jax_weights  # noqa: E402
from repro.gan import sampler as jsampler  # noqa: E402
from repro.gan import trainer as jtrainer  # noqa: E402
from repro.synth import sampler as jsynth  # noqa: E402
from repro.tabular import encoders as jenc  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.architectures import (_clone_states,  # noqa: E402
                                            run_federated)
from repro_torch.fed import (FederatedProgram, FaultPlan,  # noqa: E402
                             build_fault_plan, resolve_weights,
                             setup_federation, tile_federation)
from repro_torch.gan.ctgan import CTGANConfig  # noqa: E402
from repro_torch.gan.sampler import ConditionalSampler  # noqa: E402
from repro_torch.gan.trainer import (local_train_scan,  # noqa: E402
                                     make_round_batches, make_train_steps)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.synth import (DeviceSampler, SamplerDraws,  # noqa: E402
                               SamplerTables, draw_batch,
                               stack_sampler_tables)
from repro_torch.tabular import (fit_centralized_encoders,  # noqa: E402
                                 make_dataset, partition_iid)
from torch_jax_draws import round_noise  # noqa: E402

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
    and torch's thread pools would oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def fed():
    ds = make_dataset("adult", n_rows=240, seed=3)
    parts = partition_iid(ds, P, seed=3)
    return ds, parts, setup_federation(parts, ds.schema, CFG, 3, "fedtgan",
                                       device="cpu")


# ---- the chunked client axis ---------------------------------------------

def _round(fe, prog, mode, states):
    if mode == "faulted":
        plan = build_fault_plan("chaos", 1, P, seed=1)
        return prog.faulted_round(states, fe.tables, fe.weights,
                                  FaultPlan(*(leaf[0] for leaf in plan)))
    return prog.weighted_round(states, fe.tables, fe.weights)


@pytest.mark.parametrize("mode", ["dense", "fedprox", "faulted"])
@pytest.mark.parametrize("chunk", [1, 2, P, 2 * P])
def test_chunked_round_is_bit_identical_to_dense(fed, chunk, mode):
    _, _, fe = fed
    kw = dict(batch=CFG.batch_size, local_steps=E, weighting="fedtgan",
              fedprox_mu=0.01 if mode == "fedprox" else 0.0)
    out = []
    for c in (None, chunk):
        prog = FederatedProgram(CFG, fe.spans, fe.cond_spans,
                                client_chunk=c, **kw)
        with ops.dispatch_scope() as d:
            states, m = _round(fe, prog, mode, _clone_states(fe.states))
        assert d["weighted_agg_ref"] == 1
        out.append((states, m))
    (dense, dm), (chunked, cm) = out
    assert dm.keys() == cm.keys() and dm["d_loss"].shape == (P, E)
    for k in dm:
        assert torch.equal(dm[k], cm[k]), k
    for a, b in zip(dense, chunked):
        for x, y in zip(a.params(), b.params()):
            assert torch.equal(x, y)
        for x, y in zip(a.g_opt.mu + a.g_opt.nu + a.d_opt.mu + a.d_opt.nu,
                        b.g_opt.mu + b.g_opt.nu + b.d_opt.mu + b.d_opt.nu):
            assert torch.equal(x, y)
        assert torch.equal(a.rng.get_state(), b.rng.get_state())


def test_run_federated_chunked_on_the_host_program_equals_dense(fed):
    """``program="host"`` with ``client_chunk=2``: the dense run's
    generator bit for bit (``program="fed"`` in ``test_torch_fed.py``)."""
    ds, parts, _ = fed
    kw = dict(cfg=CFG, rounds=2, local_steps=1, seed=1, program="host",
              device="cpu")
    dense = run_federated(parts, ds.schema, **kw)
    chunked = run_federated(parts, ds.schema, client_chunk=2, **kw)
    for a, b in zip(dense.final_g_params.parameters(),
                    chunked.final_g_params.parameters()):
        assert torch.equal(a, b)


def test_indivisible_chunk_raises(fed):
    ds, parts, fe = fed
    prog = FederatedProgram(CFG, fe.spans, fe.cond_spans,
                            batch=CFG.batch_size, local_steps=1,
                            client_chunk=3)
    with pytest.raises(ValueError, match="divide the client count P=4"):
        prog.weighted_round(_clone_states(fe.states), fe.tables, fe.weights)
    for bad in (0, -2):
        with pytest.raises(ValueError, match="client_chunk must be >= 1"):
            FederatedProgram(CFG, fe.spans, fe.cond_spans,
                             batch=CFG.batch_size, local_steps=1,
                             client_chunk=bad)
        with pytest.raises(ValueError, match="must be >= 1"):
            prog.engine.clients_round(fe.states, fe.tables,
                                      client_chunk=bad)
    with pytest.raises(ValueError, match="divide"):
        run_federated(parts, ds.schema, cfg=CFG, rounds=1, client_chunk=3,
                      device="cpu")


# ---- tile_federation --------------------------------------------------------

def test_tile_federation_tiles_tables_states_and_weights(fed):
    _, _, fe = fed
    big = tile_federation(fe, 3 * P)
    assert big.n_clients == 3 * P and len(big.states) == 3 * P
    for p in range(3 * P):
        assert big.tables[p] is fe.tables[p % P]          # shared, read-only
        for a, b in zip(big.states[p].params(), fe.states[p % P].params()):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert torch.equal(big.S, fe.S.repeat(3, 1))
    np.testing.assert_array_equal(_np(big.n_rows), np.tile(_np(fe.n_rows), 3))
    assert torch.equal(big.weights,
                       resolve_weights("fedtgan", big.S, big.n_rows))
    np.testing.assert_allclose(
        _np(big.weights), np.asarray(jax_weights(
            "fedtgan", jnp.asarray(_np(big.S)), jnp.asarray(_np(big.n_rows)))),
        rtol=1e-5)
    assert abs(float(big.weights.sum()) - 1.0) < 1e-5
    assert len(big.client_stats) == 3 * P
    assert big.client_stats[P] is fe.client_stats[0]
    # the replicas are independent: a step of one leaves the others
    with torch.no_grad():
        big.states[P].params()[0].add_(1.0)
    assert torch.equal(big.states[0].params()[0], fe.states[0].params()[0])


def test_tile_federation_gives_fresh_streams(fed):
    _, _, fe = fed
    big = tile_federation(fe, 2 * P)
    seeds = [s.rng.initial_seed() for s in big.states]
    assert len(set(seeds)) == 2 * P
    assert not set(seeds) & {s.rng.initial_seed() for s in fe.states}
    assert seeds == [s.rng.initial_seed()
                     for s in tile_federation(fe, 2 * P).states]
    # client 0 and its replica P draw from one table, not in lockstep
    first = [draw_batch(big.tables[p], CFG.batch_size, fe.enc.cond_dim,
                        generator=big.states[p].rng)[2] for p in (0, P)]
    assert not torch.equal(*first)


def test_tile_federation_identity_and_errors(fed):
    _, _, fe = fed
    assert tile_federation(fe, P) is fe
    for bad in (P + 1, 0, P // 2):
        with pytest.raises(ValueError, match="positive multiple"):
            tile_federation(fe, bad)
    plan = fe.fault_plan("chaos", 3, seed=2)
    for a, b in zip(plan, build_fault_plan("chaos", 3, P, seed=2)):
        assert torch.equal(a, b)
    assert fe.fault_plan("none", 3) is None


# ---- the presampled baseline ---------------------------------------------

@pytest.fixture(scope="module")
def table():
    """Two clients' encoded rows (the port's encoders on a small adult
    table, 150 and 90 rows) and the spans in each package's type."""
    ds = make_dataset("adult", n_rows=240, seed=5)
    enc = fit_centralized_encoders(ds.data, ds.schema, device="cpu",
                                   generator=torch.Generator().manual_seed(5))
    encoded = enc.encode(ds.data,
                         generator=torch.Generator().manual_seed(6)).numpy()

    def jspans(spans):
        return [jenc.SpanInfo(s.start, s.width, s.activation, s.column,
                              s.is_condition) for s in spans]

    class JaxSpans:          # what the reference's samplers read
        @staticmethod
        def condition_spans():
            return jspans(enc.condition_spans())
    return enc, [encoded[:150], encoded[150:]], JaxSpans, jspans


def test_host_sampler_draws_the_references_arrays(table):
    enc, (rows, _), jax_enc, _ = table
    ours = ConditionalSampler(rows, enc, seed=11)
    theirs = jsampler.ConditionalSampler(rows, jax_enc, seed=11)
    for draw in (lambda s: s.sample(64), lambda s: s.sample_loop(24),
                 lambda s: (s.sample_uniform_rows(16),),
                 lambda s: s.presample_rounds(2, 3, 8)):
        for a, b in zip(draw(ours), draw(theirs), strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    cond, mask, real = ours.presample_rounds(2, 3, 8)
    assert cond.shape[:3] == (2, 3, 8) and real.shape[-1] == rows.shape[1]


def test_make_round_batches_matches_reference(table):
    enc, clients, jax_enc, _ = table
    ours = make_round_batches(
        [ConditionalSampler(r, enc, seed=i) for i, r in enumerate(clients)],
        2, 3, 8, device="cpu")
    theirs = jtrainer.make_round_batches(
        [jsampler.ConditionalSampler(r, jax_enc, seed=i)
         for i, r in enumerate(clients)], 2, 3, 8)
    for a, b in zip(ours, theirs, strict=True):
        assert a.shape == (2, 2, 3, 8) + a.shape[4:] and a.device.type == "cpu"
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_stack_sampler_tables_matches_reference(table):
    """Zero-padded to the larger client, every field equal to the
    reference's; a draw from row p of the stack, with the same draws
    injected, equals the draw from client p's own tables."""
    enc, clients, jax_enc, _ = table
    samplers = [DeviceSampler(r, enc, "cpu") for r in clients]
    stacked = stack_sampler_tables(samplers)
    theirs = jsynth.stack_sampler_tables(
        [jsynth.DeviceSampler(r, jax_enc) for r in clients])
    assert stacked.encoded.shape == (2, 150, enc.encoded_dim)
    for f in SamplerTables._fields:
        np.testing.assert_array_equal(_np(getattr(stacked, f)),
                                      np.asarray(getattr(theirs, f)), f)
    gen = torch.Generator().manual_seed(3)
    n_spans = stacked.cum.shape[1]
    for p, s in enumerate(samplers):
        row = SamplerTables(*(x[p] for x in stacked))
        draws = SamplerDraws(
            torch.randint(0, n_spans, (64,), generator=gen),
            torch.rand(64, generator=gen), torch.rand(64, generator=gen))
        for a, b in zip(draw_batch(row, 64, enc.cond_dim, draws=draws),
                        draw_batch(s.tables, 64, enc.cond_dim, draws=draws)):
            assert torch.equal(a, b)


def test_local_train_scan_matches_reference(table):
    """E presampled steps from the reference's state, its step noise
    injected: losses, moments and parameters within the local round's
    tolerance."""
    enc, (rows, _), jax_enc, jspans = table
    batches = make_round_batches([ConditionalSampler(rows, enc, seed=2)],
                                 1, E, CFG.batch_size, device="cpu")
    jbatches = jtrainer.make_round_batches(
        [jsampler.ConditionalSampler(rows, jax_enc, seed=2)], 1, E,
        CFG.batch_size)
    jstate = jax.jit(jtrainer.init_gan_state, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(7), CFG, enc.cond_dim, enc.encoded_dim)
    jstep = jtrainer.make_train_steps(CFG, jspans(enc.spans()),
                                      jspans(enc.condition_spans()))
    # jitted: an eager lax.scan compiles its body again at every call
    jnew, jm = jax.jit(lambda st, b: jtrainer.local_train_scan(jstep, st, b))(
        jstate, tuple(b[0, 0] for b in jbatches))
    state = interop.gan_state_from_reference(_flatten(jstate), CFG,
                                             device="cpu")
    step = make_train_steps(CFG, enc.spans(), enc.condition_spans())
    state, m = local_train_scan(
        step, state, tuple(b[0, 0] for b in batches),
        noise=round_noise(jstate.rng, CFG, enc.spans(), CFG.batch_size,
                          enc.encoded_dim, E))
    for k in ("d_loss", "g_loss", "wgan", "gp", "ce"):
        assert m[k].shape == (E,)
        np.testing.assert_allclose(_np(m[k]), np.asarray(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    carried = interop.gan_state_from_reference(_flatten(jnew), CFG,
                                               device="cpu")
    assert state.step == carried.step == E
    for ours, theirs in ((state.g_opt, carried.g_opt),
                         (state.d_opt, carried.d_opt)):
        for a, b in zip(ours.mu + ours.nu, theirs.mu + theirs.nu,
                        strict=True):
            np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=2e-6)
    diff = []
    for a, b in zip(state.params(), carried.params(), strict=True):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=CFG.lr * E)
        diff.append(np.abs(_np(a) - _np(b)).ravel())
    assert np.mean(np.concatenate(diff) <= 2e-6) >= 0.99
