"""The port's serving slice held against the JAX package, and the port's
server held to the reference server's contracts.

Generator and encoders are carried over from the reference
(``repro_torch.interop``); the reference's ``z``, activation uniforms and
sampler draws are reproduced here from the same ``jax.random`` splits and
injected into the port.  Categorical columns must be equal; continuous
columns close (rtol 1e-4, atol 1e-4: XLA and PyTorch sum the generator's
matrix products and batch-norm statistics in another order, and the
decode scales alpha by 4 sd, up to ~30 on this table).

The server tests mirror ``tests/test_serve.py`` on the port alone: a
response equals ``synthesize_table`` at its bucket, sliced; a seed
reproduces; nothing runs for the first time after ``warmup``; one decode
dispatch per request; the continuous scheduler keeps FIFO order on one
tenant and interleaves two.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro.gan import ctgan as jctgan  # noqa: E402
from repro.synth import DeviceSampler as JaxDeviceSampler  # noqa: E402
from repro.synth import draw_batch as jax_draw_batch  # noqa: E402
from repro.synth import synthesize_table as jax_synthesize  # noqa: E402
from repro.tabular import datasets as jds  # noqa: E402
from repro.tabular import encoders as jenc  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.gan.ctgan import (CTGANConfig, apply_activations,  # noqa: E402
                                   apply_activations_fused, init_generator)
from repro_torch.launch.serve import make_tenant, run_tabular_server  # noqa: E402
from repro_torch.serve import (BucketLadder, RequestTooLarge,  # noqa: E402
                               ServerOverloaded, StreamingSynthesizer,
                               TableRegistry)
from repro_torch.synth import (DeviceSampler, SamplerDraws,  # noqa: E402
                               draw_batch, synthesize_table)
from repro_torch.tabular import ColumnSpec, fit_centralized_encoders  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

CFG = CTGANConfig(z_dim=16, gen_hidden=(32, 32), disc_hidden=(32, 32),
                  pac=2, batch_size=8)


@pytest.fixture(scope="module", autouse=True)
def _full_precision():
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def pair():
    """One adult table with reference encoders and generator, and the same
    state carried over to the port on the CPU."""
    ds = jds.make_dataset("adult", n_rows=512, seed=5)
    key = jax.random.PRNGKey(5)
    enc = jenc.fit_centralized_encoders(ds.data, ds.schema, key)
    g = jctgan.init_generator(jax.random.PRNGKey(6), CFG, enc.cond_dim,
                              enc.encoded_dim)
    encoded = np.asarray(enc.encode(ds.data, key))
    vgms = {j: {f: np.asarray(getattr(p, f))
                for f in ("weights", "means", "stds", "valid")}
            for j, p in enc.vgms.items()}
    cats = {j: le.categories for j, le in enc.label_encoders.items()}
    port_enc = interop.encoders_from_reference(ds.schema, vgms, cats,
                                               device="cpu")
    port_g = interop.generator_from_reference(_flatten(g), device="cpu")
    return ds, enc, g, encoded, port_enc, port_g


def test_generator_forward_matches_reference(pair):
    _, enc, g, _, _, port_g = pair
    rng = np.random.default_rng(0)
    z = rng.normal(size=(96, CFG.z_dim)).astype(np.float32)
    cond = (rng.random((96, enc.cond_dim)) < 0.1).astype(np.float32)
    expect = np.asarray(jctgan.generator_forward(g, jnp.asarray(z),
                                                 jnp.asarray(cond), 2))
    with torch.no_grad():
        ours = port_g(torch.from_numpy(z), torch.from_numpy(cond)).numpy()
    np.testing.assert_allclose(ours, expect, rtol=1e-5, atol=1e-5)


def test_generator_init_and_carry_over_shapes(pair):
    _, enc, g, _, port_enc, port_g = pair
    fresh = init_generator(CFG, enc.cond_dim, enc.encoded_dim,
                           generator=torch.Generator().manual_seed(0))
    assert [p.shape for p in fresh.parameters()] == \
        [p.shape for p in port_g.parameters()]
    lim = 1.0 / np.sqrt(CFG.z_dim + enc.cond_dim)
    w = fresh.res[0].fc.weight.detach()
    assert float(w.abs().max()) <= lim and float(w.abs().max()) > 0.9 * lim


def _jax_uniforms(key, spans, n, dim):
    """The per-span activation uniforms of ``ops.segment_activations``,
    laid out in the encoded row (tanh spans 0.5)."""
    u = np.full((n, dim), 0.5, np.float32)
    for s, k in zip(spans, jax.random.split(key, len(spans))):
        if s.activation != "tanh":
            u[:, s.start:s.start + s.width] = np.asarray(
                jax.random.uniform(k, (n, s.width), jnp.float32))
    return torch.from_numpy(u)


def test_apply_activations_loop_matches_fused(pair):
    _, _, _, _, port_enc, _ = pair
    spans = port_enc.spans()
    logits = torch.randn(64, port_enc.encoded_dim,
                         generator=torch.Generator().manual_seed(1))
    u = torch.rand(logits.shape, generator=torch.Generator().manual_seed(2))
    for hard in (False, True):
        torch.testing.assert_close(
            apply_activations_fused(logits, spans, u, 0.2, hard),
            apply_activations(logits, spans, u, 0.2, hard), rtol=0,
            atol=2e-6)


def _cat_cont(schema):
    return ([j for j, c in enumerate(schema) if c.kind == "categorical"],
            [j for j, c in enumerate(schema) if c.kind == "continuous"])


def _compare_tables(ours, expect, schema):
    cat, cont = _cat_cont(schema)
    np.testing.assert_array_equal(ours[:, cat], expect[:, cat])
    np.testing.assert_allclose(ours[:, cont], expect[:, cont], rtol=1e-4,
                               atol=1e-4)


def test_synthesize_table_unconditional_matches_reference(pair):
    ds, enc, g, _, port_enc, port_g = pair
    n, key = 128, jax.random.PRNGKey(11)
    kz, ka = jax.random.split(key)
    z = torch.from_numpy(np.array(jax.random.normal(kz, (n, CFG.z_dim))))
    spans = port_enc.spans()
    u = _jax_uniforms(ka, spans, n, port_enc.encoded_dim)
    expect = jax_synthesize(g, key, CFG, enc, n)
    ours = synthesize_table(port_g, CFG, port_enc, n, z=z, uniforms=u,
                            device="cpu")
    _compare_tables(ours, expect, ds.schema)


def _jax_sampler_draws(kc, n, n_spans):
    k_span, k_cat, k_row = jax.random.split(kc, 3)
    return SamplerDraws(*(torch.from_numpy(np.array(a)) for a in (
        jax.random.randint(k_span, (n,), 0, n_spans),
        jax.random.uniform(k_cat, (n,)), jax.random.uniform(k_row, (n,)))))


def test_draw_batch_matches_reference(pair):
    _, enc, _, encoded, port_enc, _ = pair
    jt = JaxDeviceSampler(encoded, enc).tables
    pt = DeviceSampler(encoded, port_enc, "cpu").tables
    kc = jax.random.PRNGKey(3)
    expect = jax_draw_batch(jt, kc, 200, enc.cond_dim)
    ours = draw_batch(pt, 200, port_enc.cond_dim,
                      draws=_jax_sampler_draws(kc, 200, pt.cum.shape[0]))
    for a, b in zip(ours, expect):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_synthesize_table_conditional_matches_reference(pair):
    ds, enc, g, encoded, port_enc, port_g = pair
    n, key = 128, jax.random.PRNGKey(12)
    jt = JaxDeviceSampler(encoded, enc).tables
    pt = DeviceSampler(encoded, port_enc, "cpu").tables
    kc, kz, ka = jax.random.split(key, 3)
    draws = _jax_sampler_draws(kc, n, pt.cum.shape[0])
    z = torch.from_numpy(np.array(jax.random.normal(kz, (n, CFG.z_dim))))
    u = _jax_uniforms(ka, port_enc.spans(), n, port_enc.encoded_dim)
    expect = jax_synthesize(g, key, CFG, enc, n, tables=jt)
    ours = synthesize_table(port_g, CFG, port_enc, n, tables=pt, draws=draws,
                            z=z, uniforms=u, device="cpu")
    _compare_tables(ours, expect, ds.schema)


def test_kernels_get_contiguous_float32_inputs(pair, monkeypatch):
    """On the card the kernel wrappers raise on strided or non-float32
    inputs; the plans and the activation packing must never hand them
    any.  Checked on the plain route, which takes the same arguments."""
    from repro_torch.kernels import ref as plain
    seen = []

    def checked(fn):
        def wrapper(*args, **kw):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            assert all(t.is_contiguous() and t.dtype == torch.float32
                       for t in tensors), fn.__name__
            seen.append(fn.__name__)
            return fn(*args, **kw)
        return wrapper
    for name in ("vgm_encode_table_ref", "vgm_decode_table_ref",
                 "segment_activations_ref"):
        monkeypatch.setattr(plain, name, checked(getattr(plain, name)))
    ds, _, _, encoded, port_enc, port_g = pair
    port_enc.encode(ds.data, generator=torch.Generator().manual_seed(0))
    tables = DeviceSampler(encoded, port_enc, "cpu").tables
    synthesize_table(port_g, CFG, port_enc, 64, tables=tables,
                     generator=torch.Generator().manual_seed(0), device="cpu")
    assert sorted(seen) == ["segment_activations_ref", "vgm_decode_table_ref",
                            "vgm_encode_table_ref"]


# ---- the port's server --------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """One warm server over a small adult table on the CPU (untrained
    generator: serving correctness does not depend on training)."""
    ds, enc, gen, encoded = make_tenant("adult", n_rows=500, cfg=CFG,
                                        seed=3, device="cpu")
    registry = TableRegistry()
    registry.register("adult", CFG, enc, gen,
                      ladder=BucketLadder((64, 128, 256)), encoded=encoded,
                      device="cpu")
    server = StreamingSynthesizer(registry, device="cpu")
    built = server.warmup(conditional=None)
    return ds, enc, gen, registry, server, built


def _oracle(served, seed, bucket, conditional=False, hard=True):
    _, enc, gen, registry, _, _ = served
    tables = registry.get("adult").tables if conditional else None
    return synthesize_table(gen, CFG, enc, bucket, hard=hard, tables=tables,
                            generator=torch.Generator().manual_seed(seed),
                            device="cpu")


class TestServerContracts:
    def test_bucket_exact_request_matches_oracle(self, served):
        server = served[4]
        server.submit("adult", 128, seed=41)
        [resp] = server.serve()
        assert resp.bucket == 128
        np.testing.assert_array_equal(resp.data, _oracle(served, 41, 128))

    @pytest.mark.parametrize("pipeline", [True, False])
    def test_mixed_trace_fifo_and_equal_to_oracle(self, served, pipeline):
        registry = served[3]
        server = StreamingSynthesizer(registry, pipeline=pipeline,
                                      device="cpu")
        trace = [(17, 50), (128, 51), (200, 52), (64, 53), (100, 54)]
        rids = [server.submit("adult", rows, seed=s) for rows, s in trace]
        resps = server.serve()
        assert [r.rid for r in resps] == rids
        for r, (rows, s) in zip(resps, trace):
            assert (r.rows, r.bucket) == (rows, registry.get(
                "adult").ladder.bucket_for(rows))
            np.testing.assert_array_equal(r.data,
                                          _oracle(served, s, r.bucket)[:rows])

    def test_same_seed_reproduces(self, served):
        server = served[4]
        server.submit("adult", 70, seed=7)
        server.submit("adult", 70, seed=7)
        server.submit("adult", 70, seed=8)
        a, b, c = server.serve()
        np.testing.assert_array_equal(a.data, b.data)
        assert not np.array_equal(a.data, c.data)

    def test_conditional_request_matches_oracle(self, served):
        server = served[4]
        server.submit("adult", 90, seed=43, conditional=True)
        [resp] = server.serve()
        np.testing.assert_array_equal(
            resp.data, _oracle(served, 43, 128, conditional=True)[:90])
        assert not np.array_equal(resp.data, _oracle(served, 43, 128)[:90])

    def test_no_first_runs_after_warmup(self, served):
        server, built = served[4], served[5]
        assert built == 6                      # 3 buckets x (uncond, cond)
        before = server.stats()
        for i, rows in enumerate([64, 100, 128, 17, 256, 200, 64, 128]):
            server.submit("adult", rows, seed=100 + i,
                          conditional=bool(i % 2))
        resps = server.serve()
        after = server.stats()
        assert after["serving_compiles"] == before["serving_compiles"]
        assert after["cache_hits"] - before["cache_hits"] == len(resps)
        assert all(r.cache_hit for r in resps)
        assert server.warmup(conditional=None) == 0

    def test_first_run_outside_warmup_counts_as_serving_compile(self, served):
        server = StreamingSynthesizer(served[3], device="cpu")
        server.submit("adult", 64, seed=1, hard=False)
        server.submit("adult", 64, seed=2, hard=False)
        a, b = server.serve()
        assert (a.cache_hit, b.cache_hit) == (False, True)
        assert server.stats()["serving_compiles"] == 1

    def test_one_decode_dispatch_per_request(self, served):
        server = served[4]
        for i in range(3):
            server.submit("adult", 50 + i, seed=200 + i)
        resps = server.serve()
        assert [r.decode_dispatches for r in resps] == [1, 1, 1]
        assert set(server.stats()["decode_dispatches"]) == {1}

    def test_continuous_single_tenant_is_fifo(self, served):
        registry = served[3]
        trace = [(30, 60), (200, 61), (64, 62), (129, 63)]
        out = {}
        for sched in ("fifo", "continuous"):
            server = StreamingSynthesizer(registry, scheduler=sched,
                                          quantum=64, device="cpu")
            rids = [server.submit("adult", r, seed=s) for r, s in trace]
            resps = server.serve()
            assert [r.rid for r in resps] == rids
            out[sched] = [r.data for r in resps]
        for a, b in zip(out["fifo"], out["continuous"]):
            np.testing.assert_array_equal(a, b)

    def test_continuous_interleaves_two_tenants(self, served):
        _, _, _, registry, _, _ = served
        rng = np.random.default_rng(9)
        table = np.stack([rng.normal(size=300),
                          rng.integers(0, 4, 300).astype(np.float64),
                          rng.normal(2.0, 0.5, 300)], axis=1)
        schema = [ColumnSpec("a", "continuous", max_modes=4),
                  ColumnSpec("b", "categorical"),
                  ColumnSpec("c", "continuous", max_modes=4)]
        g = torch.Generator().manual_seed(9)
        enc2 = fit_centralized_encoders(table, schema, generator=g,
                                        device="cpu")
        cfg2 = CTGANConfig(z_dim=4, gen_hidden=(8,))
        gen2 = init_generator(cfg2, enc2.cond_dim, enc2.encoded_dim,
                              generator=g)
        reg = TableRegistry()
        reg.register("adult", CFG, registry.get("adult").encoders,
                     registry.get("adult").gen, ladder=BucketLadder((64,)),
                     device="cpu")
        reg.register("small", cfg2, enc2, gen2, ladder=BucketLadder((64,)),
                     device="cpu")
        server = StreamingSynthesizer(reg, scheduler="continuous", quantum=64,
                                      device="cpu")
        for i in range(3):
            server.submit("adult", 64, seed=300 + i)
        for i in range(3):
            server.submit("small", 40, seed=400 + i)
        resps = server.serve()
        # each DRR cycle admits one request of each tenant
        tables = [r.table for r in resps]
        assert [set(tables[i:i + 2]) for i in (0, 2, 4)] == \
            [{"adult", "small"}] * 3
        for r in resps:
            cfg, enc, gen = ((CFG, reg.get("adult").encoders,
                              reg.get("adult").gen) if r.table == "adult"
                             else (cfg2, enc2, gen2))
            seed = 300 + r.rid if r.table == "adult" else 400 + r.rid - 3
            expect = synthesize_table(
                gen, cfg, enc, 64, generator=torch.Generator().manual_seed(seed),
                device="cpu")
            np.testing.assert_array_equal(r.data, expect[:r.rows])

    def test_bounded_queue_raises_overloaded(self, served):
        server = StreamingSynthesizer(served[3], max_queue=2, device="cpu")
        server.submit("adult", 10, seed=1)
        server.submit("adult", 10, seed=2)
        with pytest.raises(ServerOverloaded):
            server.submit("adult", 10, seed=3)
        assert server.stats()["rejected_overload"] == 1
        assert len(server.serve()) == 2

    @pytest.mark.parametrize("scheduler", ["fifo", "continuous"])
    def test_expired_requests_are_dropped(self, served, scheduler):
        now = [0.0]
        server = StreamingSynthesizer(served[3], scheduler=scheduler,
                                      clock=lambda: now[0], device="cpu")
        server.submit("adult", 10, seed=1, deadline=5.0)
        keep = server.submit("adult", 10, seed=2)
        now[0] = 6.0
        assert [r.rid for r in server.serve()] == [keep]
        assert server.stats()["expired"] == 1

    def test_refit_ladder_runs_new_rungs_before_the_swap(self, served):
        _, _, _, registry, _, _ = served
        server = StreamingSynthesizer(registry, device="cpu")
        old = registry.get("adult").ladder
        try:
            assert server.refit_ladder("adult", sizes=old.buckets) is None
            new = server.refit_ladder("adult", sizes=[30, 300])
            assert new.buckets == (64, 512)
            assert registry.get("adult").ladder is new
            assert server.stats()["warmup_compiles"] == 4   # 2 rungs x 2 modes
            server.submit("adult", 300, seed=5)
            [resp] = server.serve()
            assert (resp.bucket, resp.cache_hit) == (512, True)
            np.testing.assert_array_equal(resp.data,
                                          _oracle(served, 5, 512)[:300])
        finally:
            registry.get("adult").ladder = old

    def test_guards(self, served):
        _, enc, gen, registry, server, _ = served
        with pytest.raises(RequestTooLarge):
            server.submit("adult", 257)
        with pytest.raises(ValueError, match="already registered"):
            registry.register("adult", CFG, enc, gen, device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                StreamingSynthesizer(registry)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                synthesize_table(gen, CFG, enc, 8)
        assert len(server) == 0


def test_run_tabular_server_on_cpu():
    stats = run_tabular_server(requests=4, sizes=(50, 130), n_rows=300,
                               cfg=CFG, device="cpu", conditional=True,
                               scheduler="continuous", quiet=True)
    assert stats["requests"] == 4 and stats["serving_compiles"] == 0
    assert stats["decode_dispatches"] == {1: 4}
