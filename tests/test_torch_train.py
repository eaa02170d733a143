"""The port's training slice held against the JAX package on the CPU.

The same numpy-seeded inputs, and the reference's own random draws
(reproduced from its key splits, ``tests/torch_jax_draws.py``), go
through the reference and the port.  State is carried over with
``repro_torch.interop``.  Pallas kernels run in interpret mode.

Tolerances:
  * activation gradients: atol 2e-6, for the reason
    ``tests/test_torch_kernels.py`` gives (XLA's and PyTorch's
    vectorized log/exp/tanh differ by an ulp or two, and 1/tau = 5
    amplifies the scaled logits' error).
  * Adam: rtol 1e-6, atol 1e-9 -- the same float32 operations in the
    same order; XLA may contract the moment updates into fused
    multiply-adds and compute b^t another way, an ulp or two.
  * critic, gradient penalty, conditional loss: rtol 1e-5, atol 1e-6 --
    matrix products and reductions summed in another order.
  * a whole train step and a local round: losses rtol 1e-4; Adam moments
    atol 2e-6 (they hold the gradients, whose products and reductions
    are summed in another order, through a double backward); parameters
    atol lr per step taken, and 99% of their elements atol 2e-6.  Adam's
    step, ``lr * mhat / (sqrt(vhat) + eps)``, does not shrink with the
    gradient: where a gradient is zero up to rounding (the biases of the
    generator's Linear layers before batch norm, which cancels them, and
    the logits of saturated softmax lanes) the two packages' rounding
    noise gives steps of up to lr in unrelated directions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro.gan import ctgan as jctgan  # noqa: E402
from repro.gan import trainer as jtrainer  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.synth import DeviceSampler as JaxDeviceSampler  # noqa: E402
from repro.synth import RoundEngine as JaxRoundEngine  # noqa: E402
from repro.synth import draw_batch as jax_draw_batch  # noqa: E402
from repro.tabular import datasets as jds  # noqa: E402
from repro.tabular import encoders as jenc  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.gan.ctgan import (CTGANConfig, conditional_loss,  # noqa: E402
                                   gradient_penalty)
from repro_torch.gan.trainer import (init_gan_state,  # noqa: E402
                                     make_train_steps)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.optim import AdamState, adam  # noqa: E402
from repro_torch.synth import DeviceSampler, RoundEngine  # noqa: E402
from torch_jax_draws import (activation_uniforms, dropout_keeps,  # noqa: E402
                             round_noise, sampler_draws, step_noise)
from torch_kernel_inputs import ACT_LAYOUTS  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

CFG = CTGANConfig(z_dim=8, gen_hidden=(16, 16), disc_hidden=(16, 16),
                  pac=2, batch_size=8)


@pytest.fixture(scope="module", autouse=True)
def _full_precision():
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("route", ["plain", "pallas_interpret"])
def test_activation_gradients_match_reference(hard, route):
    """``torch.autograd`` through the port's activations against
    ``jax.grad`` through the reference's, soft and straight-through."""
    spans = ACT_LAYOUTS["ctgan"]
    N, tau = 64, 0.2
    dim = spans[-1].start + spans[-1].width
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(N, dim)).astype(np.float32) * 2.0
    cot = rng.uniform(-1, 1, size=(N, dim)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    kw = (dict(use_pallas=False) if route == "plain"
          else dict(use_pallas=True, interpret=True))

    def loss(x):
        return jnp.sum(jops.segment_activations(x, spans, key, tau, hard,
                                                **kw) * cot)
    expect = np.asarray(jax.grad(loss)(jnp.asarray(logits)))
    assert np.abs(expect).max() > 0.1
    x = torch.from_numpy(logits).requires_grad_()
    out = ops.segment_activations(x, spans,
                                  activation_uniforms(key, spans, N, dim),
                                  tau, hard=hard)
    torch.sum(out * torch.from_numpy(cot)).backward()
    np.testing.assert_allclose(x.grad.numpy(), expect, rtol=0, atol=2e-6)


def test_adam_matches_reference_over_steps():
    rng = np.random.default_rng(0)
    shapes = [(6, 4), (4,), (1,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jopt = jadam(2e-4, 0.5, 0.9)
    jparams = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jparams)
    update = jax.jit(jopt.update)
    opt = adam(2e-4, 0.5, 0.9)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    tstate = opt.init(tparams)
    for _ in range(5):
        grads = [rng.normal(size=s).astype(np.float32) * 10 ** rng.uniform(
            -6, 1) for s in shapes]
        jparams, jstate = update([jnp.asarray(g) for g in grads], jstate,
                                 jparams)
        tstate = opt.update([torch.from_numpy(g) for g in grads], tstate,
                            tparams)
    assert tstate.count == int(jstate.count) == 5
    for ours, theirs in ((tparams, jparams), (tstate.mu, jstate.mu),
                         (tstate.nu, jstate.nu)):
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)


@pytest.fixture(scope="module")
def table():
    """A small adult table with the reference's encoders, carried over."""
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
    return enc, encoded, port_enc


@pytest.fixture(scope="module")
def critic(table):
    enc = table[0]
    d = jctgan.init_discriminator(jax.random.PRNGKey(4), CFG, enc.cond_dim,
                                  enc.encoded_dim)
    port = interop.discriminator_from_reference(_flatten(d), pac=CFG.pac,
                                                dropout=CFG.dropout,
                                                device="cpu")
    rng = np.random.default_rng(4)
    width = enc.encoded_dim + enc.cond_dim
    real = rng.random((CFG.batch_size, width)).astype(np.float32)
    fake = rng.random((CFG.batch_size, width)).astype(np.float32)
    return d, port, real, fake


def test_discriminator_matches_reference(critic):
    d, port, real, _ = critic
    key = jax.random.PRNGKey(9)
    for train in (True, False):
        expect = np.asarray(jctgan.discriminator_forward(
            d, jnp.asarray(real), key, CFG, train=train))
        keep = dropout_keeps(key, CFG, CFG.batch_size) if train else None
        ours = port(torch.from_numpy(real), train=train, keep=keep)
        assert ours.shape == (CFG.batch_size // CFG.pac,)
        np.testing.assert_allclose(_np(ours), expect, rtol=1e-5, atol=1e-6)


def test_gradient_penalty_value_and_critic_gradient(critic):
    d, port, real, fake = critic
    key = jax.random.PRNGKey(10)
    value, grads = jax.value_and_grad(
        lambda p: jctgan.gradient_penalty(p, jnp.asarray(real),
                                          jnp.asarray(fake), key, CFG))(d)
    keps, _ = jax.random.split(key)
    eps = torch.from_numpy(np.array(jax.random.uniform(
        keps, (CFG.batch_size // CFG.pac, 1, 1))))
    gp = gradient_penalty(port, torch.from_numpy(real),
                          torch.from_numpy(fake), eps)
    np.testing.assert_allclose(float(gp.detach()), float(value), rtol=1e-5)
    # the output bias does not move the input gradient: no gradient (0)
    ours = [torch.zeros_like(p) if g is None else g for g, p in zip(
        torch.autograd.grad(gp, list(port.parameters()), allow_unused=True),
        port.parameters())]
    flat = _flatten(grads)
    theirs = [flat["fc0/w"].T, flat["fc0/b"], flat["fc1/w"].T, flat["fc1/b"],
              flat["out/w"].T, flat["out/b"]]
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(_np(a), b, rtol=1e-5, atol=1e-6)


def test_conditional_loss_matches_reference(table):
    enc, encoded, port_enc = table
    jt = JaxDeviceSampler(encoded, enc).tables
    cond, mask, _ = jax_draw_batch(jt, jax.random.PRNGKey(5), 32,
                                   enc.cond_dim)
    logits = np.random.default_rng(5).normal(
        size=(32, enc.encoded_dim)).astype(np.float32)
    expect = float(jctgan.conditional_loss(jnp.asarray(logits), cond, mask,
                                           enc.condition_spans()))
    ours = conditional_loss(torch.from_numpy(logits),
                            torch.from_numpy(np.array(cond)),
                            torch.from_numpy(np.array(mask)),
                            port_enc.condition_spans())
    np.testing.assert_allclose(float(ours), expect, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jax_engine(table):
    """The reference's round engine, E = 2 (jitted once for the module)."""
    enc = table[0]
    return JaxRoundEngine(CFG, enc.spans(), enc.condition_spans(),
                          batch=CFG.batch_size, local_steps=2)


@pytest.fixture(scope="module")
def trained(table, jax_engine):
    """A reference GANState after one round of 2 jitted steps, so the Adam
    moments and count are not at their initial values."""
    enc, encoded, _ = table
    state = jtrainer.init_gan_state(jax.random.PRNGKey(7), CFG, enc.cond_dim,
                                    enc.encoded_dim)
    state, _ = jax_engine.run_round(state, JaxDeviceSampler(encoded,
                                                            enc).tables,
                                    jax.random.PRNGKey(8))
    return state


def _assert_state_close(port_state, jax_state, steps):
    """Moments atol 2e-6; parameters atol lr x ``steps``, 99% of their
    elements atol 2e-6 (see the module docstring)."""
    carried = interop.gan_state_from_reference(_flatten(jax_state), CFG,
                                               device="cpu")
    assert port_state.step == carried.step
    for ours, theirs in ((port_state.g_opt, carried.g_opt),
                         (port_state.d_opt, carried.d_opt)):
        assert ours.count == theirs.count
        for a, b in zip(ours.mu + ours.nu, theirs.mu + theirs.nu,
                        strict=True):
            np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=2e-6)
    diff = []
    for a, b in zip(port_state.params(), carried.params(), strict=True):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                   atol=CFG.lr * steps)
        diff.append(np.abs(_np(a) - _np(b)).ravel())
    assert np.mean(np.concatenate(diff) <= 2e-6) >= 0.99


def test_interop_carries_the_whole_state(trained):
    jstate = trained
    port = interop.gan_state_from_reference(_flatten(jstate), CFG,
                                            device="cpu")
    assert (port.step, port.g_opt.count, port.d_opt.count) == (2, 2, 2)
    assert float(port.g_opt.nu[0].abs().max()) > 0
    np.testing.assert_array_equal(_np(port.disc.fc[0].weight),
                                  np.asarray(jstate.d_params["fc0"]["w"]).T)
    np.testing.assert_array_equal(
        _np(port.d_opt.mu[0]), np.asarray(jstate.d_opt.mu["fc0"]["w"]).T)


def test_train_step_matches_reference(table, trained):
    """One critic + generator step from a carried-over state, fed the
    reference's draws: both losses and every parameter and moment."""
    enc, encoded, port_enc = table
    jstate = trained
    port = interop.gan_state_from_reference(_flatten(jstate), CFG,
                                            device="cpu")
    jt = JaxDeviceSampler(encoded, enc).tables
    batch = jax_draw_batch(jt, jax.random.PRNGKey(11), CFG.batch_size,
                           enc.cond_dim)
    jstep = jax.jit(jtrainer.make_train_steps(CFG, enc.spans(),
                                              enc.condition_spans()))
    jnew, jm = jstep(jstate, batch)
    noise, _ = step_noise(jstate.rng, CFG, port_enc.spans(), CFG.batch_size,
                          port_enc.encoded_dim)
    step = make_train_steps(CFG, port_enc.spans(), port_enc.condition_spans())
    m = step(port, tuple(torch.from_numpy(np.array(a)) for a in batch), noise)
    for k in ("d_loss", "g_loss", "wgan", "gp", "ce"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    _assert_state_close(port, jnew, steps=1)


def test_local_round_matches_reference(table, trained, jax_engine):
    """``RoundEngine.local_round`` with E = 2: one draw of 2 x batch rows
    (the reference's sampler draws injected), then two steps."""
    enc, encoded, port_enc = table
    jstate = trained
    port = interop.gan_state_from_reference(_flatten(jstate), CFG,
                                            device="cpu")
    key = jax.random.PRNGKey(12)
    jnew, jm = jax_engine.run_round(jstate, JaxDeviceSampler(encoded, enc).tables,
                                key)
    tables = DeviceSampler(encoded, port_enc, "cpu").tables
    ours = RoundEngine(CFG, port_enc.spans(), port_enc.condition_spans(),
                       batch=CFG.batch_size, local_steps=2)
    _, m = ours.local_round(
        port, tables,
        draws=sampler_draws(key, 2 * CFG.batch_size, tables.cum.shape[0]),
        noise=round_noise(jstate.rng, CFG, port_enc.spans(), CFG.batch_size,
                          port_enc.encoded_dim, 2))
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(_np(m[k]), np.asarray(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    _assert_state_close(port, jnew, steps=2)


def test_local_round_draws_its_own_noise_on_the_cpu(table):
    """Without injected draws a round draws from the client's generator:
    the same seed gives the same state, another seed another."""
    _, encoded, port_enc = table
    tables = DeviceSampler(encoded, port_enc, "cpu").tables
    engine = RoundEngine(CFG, port_enc.spans(), port_enc.condition_spans(),
                         batch=CFG.batch_size, local_steps=2)
    def run(seed):
        st = init_gan_state(CFG, port_enc.cond_dim, port_enc.encoded_dim,
                            generator=torch.Generator().manual_seed(0),
                            rng=torch.Generator().manual_seed(seed),
                            device="cpu")
        with ops.dispatch_scope() as d:
            _, m = engine.local_round(st, tables)
        assert d["segment_activations_ref"] == 4       # 2 per step
        assert all(bool(torch.isfinite(v).all()) for v in m.values())
        return st
    a, b, c = run(1), run(1), run(2)
    assert a.step == 2
    assert torch.equal(a.gen.out.weight, b.gen.out.weight)
    assert not torch.equal(a.gen.out.weight, c.gen.out.weight)
    assert isinstance(a.g_opt, AdamState) and a.g_opt.count == 2
