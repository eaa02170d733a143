"""The port's federated LM training slice held against the JAX package on
the CPU, at the smoke configs of ``llama3-8b`` and ``smollm-135m`` in
float32, with parameters carried across by ``repro_torch.interop`` and
numpy-seeded tokens.  The reference's flash route runs its Pallas kernel
in interpret mode; the port's runs the plain versions.

Tolerances:
  * norms, RoPE, attention blocks, logits and losses: rtol 1e-5 and atol
    1e-5 (logits of a 2-layer model: 2e-5) -- float32 matrix products and
    reductions summed in another order.
  * gradients of one step: rtol 1e-4, atol 1e-6 -- the same, through the
    backward.
  * Adam (clip, cosine schedule, bfloat16 moments): float32 parameters
    and moments rtol 1e-6, atol 1e-9 -- the same float32 operations in
    the same order, XLA may contract the moment updates into fused
    multiply-adds; bfloat16 values may sit one bfloat16 ulp apart where
    the float32 results straddle a rounding boundary (rtol 2^-7).
  * whole train steps and a federated round: losses rtol 1e-4;
    parameters atol lr per Adam step taken, and 99% of the elements atol
    2e-6.  Adam's step does not shrink with the gradient: where a
    gradient is zero up to rounding, the two packages' rounding noise
    gives steps of up to lr in unrelated directions (the rule of
    ``tests/test_torch_train.py``).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import Transformer as JTransformer  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import tokens as ttokens  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import (Transformer, tree_items,  # noqa: E402
                                tree_leaves, tree_unflatten)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ARCHS = ["llama3-8b", "smollm-135m"]
# the gradient and run_federated tests also train xLSTM: its mLSTM layers
# through the plain forward and backward of the chunkwise kernel
GRAD_ARCHS = ARCHS + ["xlstm-1.3b"]
CPU = torch.device("cpu")


def _cfg(arch, **kw):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)


def _jcfg(arch, **kw):
    return dataclasses.replace(jget_smoke(arch), dtype="float32", **kw)


@functools.lru_cache(maxsize=None)
def _reference_params(arch, seed):
    return JTransformer(_jcfg(arch)).init(jax.random.PRNGKey(seed))


def _carried(arch, seed=0):
    """The reference's initial parameters and a fresh port copy of them."""
    jparams = _reference_params(arch, seed)
    return jparams, interop.lm_params_from_reference(_flatten(jparams),
                                                     _cfg(arch), device=CPU)


def _as_reference(params) -> dict:
    """The port's parameters keyed as the reference's flattened tree, the
    per-layer leaves stacked on a leading axis."""
    out: dict = {}
    for path, t in tree_items(params):
        parts = path.split("/")
        if parts[0] == "layers":
            out.setdefault("/".join(["layers"] + parts[2:]), []).append(
                t.detach().float().numpy())
        else:
            out[path] = t.detach().float().numpy()
    return {k: np.stack(v) if isinstance(v, list) else v
            for k, v in out.items()}


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


def _close_after_adam(got: dict, want: dict, lr, steps):
    diffs = np.concatenate([np.abs(got[k] - np.asarray(want[k], np.float32)
                                   ).reshape(-1) for k in want])
    assert set(got) == set(want)
    assert diffs.max() <= lr * steps, diffs.max()
    assert np.mean(diffs <= 2e-6) >= 0.99, np.mean(diffs <= 2e-6)


# ---- layers ---------------------------------------------------------------

def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3
    scale = rng.normal(size=(48,)).astype(np.float32)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)
    got = tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    got_bf = tlayers.rms_norm(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(scale))
    assert got_bf.dtype == torch.bfloat16


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope_matches_reference(fraction):
    """Interleaved lane pairs (0::2 with 1::2), partial rotation for
    ChatGLM's fraction 0.5."""
    x = np.random.default_rng(1).normal(size=(2, 16, 4, 32)).astype(np.float32)
    pos = np.arange(16)
    want = jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0,
                            fraction)
    got = tattn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           10_000.0, fraction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_attention_block_matches_reference(arch, flash):
    jcfg = _jcfg(arch, use_flash_kernel=flash)
    jparams, params = _carried(arch)
    jblk = jax.tree.map(lambda a: a[0], jparams["layers"]["pos0"]["attn"])
    blk = params["layers"][0]["pos0"]["attn"]
    x = np.random.default_rng(2).normal(
        size=(2, 64, jcfg.d_model)).astype(np.float32)
    pos = np.arange(64)
    want = jattn.attention_block(jblk, jnp.asarray(x), cfg=jcfg,
                                 positions=jnp.asarray(pos))
    got = tattn.attention_block(blk, torch.from_numpy(x),
                                cfg=_cfg(arch, use_flash_kernel=flash),
                                positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


# ---- the model --------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    """Logits and loss of the reference's plain route against the port's
    plain and flash routes, from the same parameters."""
    jparams, params = _carried(arch)
    jmodel = JTransformer(_jcfg(arch))
    tk = _tokens(3, 2, 100, _cfg(arch).vocab)
    jbatch = {"tokens": jnp.asarray(tk), "labels": jnp.asarray(tk)}
    want_logits, _ = jmodel.forward(jparams, jbatch)
    want_loss, _ = jmodel.loss(jparams, jbatch)
    batch = {"tokens": torch.from_numpy(tk).long(),
             "labels": torch.from_numpy(tk).long()}
    for flash in (False, True):
        model = Transformer(_cfg(arch, use_flash_kernel=flash))
        with torch.no_grad():
            logits, _ = model.forward(params, batch)
            loss, metrics = model.loss(params, batch)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                                   rtol=1e-5, atol=2e-5)
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
        assert float(metrics["moe_aux"]) == 0.0


def _remat_step_calls(cfg) -> dict:
    """Plain-route calls of one loss and gradient with remat on: per
    attention layer the flash forward, the recompute's forward, dq and
    dk/dv; per mLSTM layer the forward, the recompute's forward and the
    backward."""
    n = {kind: cfg.pattern.count(kind) * cfg.n_rep for kind in
         ("attn", "mlstm")}
    calls = {"flash_attention_ref": 4 * n["attn"],
             "mlstm_chunk_ref": 2 * n["mlstm"],
             "mlstm_chunk_bwd_ref": n["mlstm"]}
    return {k: v for k, v in calls.items() if v}


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_train_step_gradients_match_reference(arch):
    """The gradient of the loss w.r.t. every parameter, through the flash
    route with remat on (each layer under torch.utils.checkpoint): 2
    flash forwards per attention layer (the recompute) and one backward;
    for xLSTM, 2 forwards of the chunkwise mLSTM per mLSTM layer and one
    plain backward (``mlstm_chunk_bwd_plain``), against ``jax.grad`` of the
    reference's jnp chunk scan."""
    jparams, params = _carried(arch)
    tk = _tokens(4, 2, 64, _cfg(arch).vocab)
    jbatch = {"tokens": jnp.asarray(tk), "labels": jnp.asarray(tk)}
    (_, _), jgrads = jax.jit(jax.value_and_grad(
        JTransformer(_jcfg(arch)).loss, has_aux=True))(jparams, jbatch)
    cfg = _cfg(arch, use_flash_kernel=True, remat=True)
    model = Transformer(cfg)
    batch = {"tokens": torch.from_numpy(tk).long(),
             "labels": torch.from_numpy(tk).long()}
    with ops.dispatch_scope() as calls:
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, tree_leaves(params))
    assert dict(calls) == _remat_step_calls(cfg)
    got = _as_reference(tree_unflatten(params, grads))
    want = _flatten(jgrads)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def test_transformer_refuses_an_unknown_block_kind():
    """Every block kind of the reference is ported; one it does not have
    raises ``ValueError(kind)``, as its ``init`` does."""
    cfg = dataclasses.replace(get_smoke_config("smollm-135m"),
                              pattern=("attn", "conv"), n_layers=2)
    with pytest.raises(ValueError, match="conv"):
        Transformer(cfg).init(seed=0, device=CPU)


# ---- Adam ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam_with_clip_and_cosine_matches_reference(dtype):
    """Three steps of the LM optimizer: cosine schedule with warm-up,
    b1 0.9, b2 0.95, global-norm clip 1.0 (active: the gradients' norm is
    ~10), weight decay, moments in the parameters' dtype."""
    rng = np.random.default_rng(5)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    gs = [[rng.normal(size=s).astype(np.float32) * 4 for s in shapes]
          for _ in range(3)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    kw = dict(b1=0.9, b2=0.95, max_grad_norm=1.0, weight_decay=0.01)
    jo = jopt.adam(jopt.cosine_schedule(1e-2, warmup=1, total=3), **kw)
    to = topt.adam(topt.cosine_schedule(1e-2, warmup=1, total=3), **kw)
    jp = [jnp.asarray(p).astype(jdt) for p in p0]
    tp = [torch.from_numpy(p).to(tdt) for p in p0]
    js, ts = jo.init(jp), to.init(tp)
    for g in gs:
        jp, js = jo.update([jnp.asarray(x).astype(jdt) for x in g], js, jp)
        ts = to.update([torch.from_numpy(x).to(tdt) for x in g], ts, tp)
    rtol, atol = (2 ** -7, 1e-6) if dtype == "bfloat16" else (1e-6, 1e-9)
    assert ts.count == int(js.count) == 3
    for want, got in ((jp, tp), (js.mu, ts.mu), (js.nu, ts.nu)):
        for w, g in zip(want, got):
            assert g.dtype == tdt
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(w.astype(jnp.float32)),
                                       rtol=rtol, atol=atol)


def test_schedules_and_clip_match_reference():
    for step in (0, 1, 5, 9, 10, 30):
        want = jopt.cosine_schedule(3e-4, warmup=10, total=20, floor=1e-5)(
            jnp.asarray(step, jnp.int32))
        got = topt.cosine_schedule(3e-4, warmup=10, total=20, floor=1e-5)(
            torch.tensor(float(step)))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(topt.constant_schedule(2e-4)(torch.tensor(3.0))) \
        == np.float32(2e-4)
    rng = np.random.default_rng(6)
    gs = [rng.normal(size=(4, 3)).astype(np.float32) * 5,
          rng.normal(size=(6,)).astype(np.float32)]
    want = jopt.clip_by_global_norm([jnp.asarray(g) for g in gs], 1.0)
    got = topt.clip_by_global_norm([torch.from_numpy(g) for g in gs], 1.0)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


# ---- token data and weights ------------------------------------------------

def test_token_data_equals_reference():
    spec_j = jtokens.TokenDatasetSpec(512, 32)
    spec_t = ttokens.TokenDatasetSpec(512, 32)
    np.testing.assert_array_equal(
        ttokens.synthetic_token_batches(spec_t, 2, 3, seed=4, shift=7),
        jtokens.synthetic_token_batches(spec_j, 2, 3, seed=4, shift=7))
    for iid in (True, False):
        js = jtokens.client_token_streams(spec_j, 4, 2, 3, iid=iid, seed=1)
        ts = ttokens.client_token_streams(spec_t, 4, 2, 3, iid=iid, seed=1)
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(
                ttokens.token_frequency_stats(a, 512),
                jtokens.token_frequency_stats(b, 512))
    stats = [ttokens.token_frequency_stats(s, 512) for s in ts]
    n = [int(s.size) * (i + 1) for i, s in enumerate(ts)]
    want = jtokens.fed_weights_from_token_stats(stats, n)
    got = ttokens.fed_weights_from_token_stats(stats, n)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# ---- the entry points ----------------------------------------------------------

def test_run_federated_round_matches_reference():
    """One round, 4 non-IID clients, fedtgan weights, 2 local steps each,
    from the reference's initial parameters: the weights, the mean loss,
    and the merged parameters every client holds."""
    _check_federated_round("smollm-135m")


def test_xlstm_run_federated_round_matches_reference():
    """The same round for xLSTM: its mLSTM layers through the plain
    forward and backward of the chunkwise kernel."""
    _check_federated_round("xlstm-1.3b")


def _check_federated_round(arch):
    lr = 1e-3
    kw = dict(clients=4, rounds=1, local_steps=2, batch=2, seq=64, lr=lr,
              iid=False, seed=0, weighting="fedtgan")
    jstates, jhist, jw = jtrain.run_federated(_jcfg(arch), **kw)
    _, params = _carried(arch, seed=0)
    rounds = []
    states, hist, w = ttrain.run_federated(
        _cfg(arch, use_flash_kernel=True), device=CPU, init_params=params,
        on_round=lambda r, st, m: rounds.append(m["loss"].shape), **kw)
    assert rounds == [(4, 2)]
    np.testing.assert_allclose(w, jw, rtol=1e-6)
    np.testing.assert_allclose(hist[0]["loss"], jhist[0]["loss"], rtol=1e-4)
    want = {k: v[0] for k, v in _flatten(jstates.params).items()}
    for st in states:
        _close_after_adam(_as_reference(st.params), want, lr, 2)
    assert all(torch.equal(a, b) for st in states[1:] for a, b in
               zip(tree_leaves(st.params), tree_leaves(states[0].params)))
    assert [s.opt_state.count for s in states] == [2] * 4


def test_run_centralized_matches_reference():
    arch, lr = "llama3-8b", 1e-3
    kw = dict(steps=3, batch=2, seq=32, lr=lr, seed=1, log_every=1)
    jstate, jhist = jtrain.run_centralized(_jcfg(arch), **kw)
    _, params = _carried(arch, seed=1)
    state, hist = ttrain.run_centralized(_cfg(arch), device=CPU,
                                         init_params=params, **kw)
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], rtol=1e-4)
    _close_after_adam(_as_reference(state.params),
                      _flatten(jstate.params), lr, 3)


def test_train_state_interop_round_trips():
    """A reference TrainState with bfloat16 parameters and moments lands
    in the port with each leaf's dtype and value, count and step."""
    jcfg = jget_smoke("smollm-135m")
    model = JTransformer(jcfg)
    params = model.init(jax.random.PRNGKey(2))
    opt = jopt.adam(1e-3, b1=0.9, b2=0.95)
    st = opt.init(params)
    grads = jax.tree.map(lambda p: jnp.ones_like(p) * 0.5, params)
    params, st = opt.update(grads, st, params)
    from repro.models import TrainState as JTrainState
    flat = _flatten(JTrainState(params, st, jnp.asarray(1, jnp.int32)))
    state = interop.lm_train_state_from_reference(
        flat, get_smoke_config("smollm-135m"), device=CPU)
    assert state.step == 1 and state.opt_state.count == 1
    leaves = tree_leaves(state.params)
    for (path, p), m in zip(tree_items(state.params), state.opt_state.mu):
        want = torch.float32 if path.endswith("norm") else torch.bfloat16
        assert p.dtype == m.dtype == want, path
    got = _as_reference(state.params)
    for key, want in _flatten(params).items():
        np.testing.assert_array_equal(got[key], want)
    assert len(leaves) == len(state.opt_state.nu)


def test_main_runs_on_the_cpu(capsys):
    ttrain.main(["--arch", "smollm-135m", "--smoke", "--federated",
                 "--clients", "2", "--rounds", "1", "--local-steps", "1",
                 "--batch", "1", "--seq", "16", "--device", "cpu"])
    assert "round    1 mean-loss" in capsys.readouterr().out
    ttrain.main(["--arch", "smollm-135m", "--smoke", "--federated",
                 "--clients", "2", "--rounds", "1", "--local-steps", "1",
                 "--batch", "1", "--seq", "16", "--dp-noise", "1.0",
                 "--dp-clip", "0.5", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "round    1 mean-loss" in out
    assert "client-level DP: clip 0.5 noise 1.0 -> eps ~=" in out
