"""The port's LM serving path -- ``Transformer.prefill``, ``decode_step``,
the KV cache and the recurrent states, ``prefill_and_decode`` -- held
against the JAX package on the CPU, at the smoke configs of
``xlstm-1.3b`` (mLSTM + sLSTM) and ``smollm-135m`` (GQA attention) in
float32, with parameters and caches carried across by
``repro_torch.interop`` and numpy-seeded or the reference's own prompts.

Tolerances:
  * logits and caches against the reference: rtol 2e-5, atol 2e-5 -- the
    same float32 formulas summed in another order, through 2 layers (the
    rule of ``tests/test_torch_lm.py``).
  * the port's one-pass prefill against its own token-by-token replay:
    rtol 1e-4, atol 1e-4 -- the chunkwise mLSTM and the per-step
    recurrence take their stabilizers at other steps, so they round
    differently (the reference's own prefill-vs-replay test allows 5e-2).
  * greedy tokens: equal.
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
from repro.launch import serve as jserve  # noqa: E402
from repro.models import Transformer as JTransformer  # noqa: E402
from repro.models.attention import KVCache as JKVCache  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ARCHS = ["xlstm-1.3b", "smollm-135m"]
CPU = torch.device("cpu")
B, S, MAX = 2, 64, 72          # S: two of the xLSTM smoke config's chunks
REF = dict(rtol=2e-5, atol=2e-5)


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def _jcfg(arch):
    return dataclasses.replace(jget_smoke(arch), dtype="float32")


@functools.lru_cache(maxsize=None)
def _reference(arch, seed=0):
    model = JTransformer(_jcfg(arch))
    return model, model.init(jax.random.PRNGKey(seed))


def _port(arch, seed=0):
    _, jparams = _reference(arch, seed)
    return Transformer(_cfg(arch)), interop.lm_params_from_reference(
        _flatten(jparams), _cfg(arch), device=CPU)


def _tokens(seed, n=S, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, n),
                                                dtype=np.int32)


def _caches_close(got, jcaches):
    want = _flatten(jcaches)
    for r, rep in enumerate(got):
        for pos, state in rep.items():
            for field, t in zip(state._fields, state, strict=True):
                np.testing.assert_allclose(
                    t.float().numpy(), want[f"{pos}/.{field}"][r], **REF,
                    err_msg=f"rep {r} {pos} {field}")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    jmodel, jparams = _reference(arch)
    model, params = _port(arch)
    tk = _tokens(1)
    batch = {"tokens": torch.from_numpy(tk), "labels": torch.from_numpy(tk)}
    with torch.no_grad():
        logits, _ = model.forward(params, batch)
        loss, _ = model.loss(params, batch)
    jbatch = {"tokens": jnp.asarray(tk), "labels": jnp.asarray(tk)}
    jlogits, _ = jmodel.forward(jparams, jbatch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **REF)
    np.testing.assert_allclose(float(loss), float(jmodel.loss(jparams,
                                                              jbatch)[0]),
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    jmodel, jparams = _reference(arch)
    model, params = _port(arch)
    tk = _tokens(2)
    before = ops.DISPATCH_COUNTS.copy()
    with torch.no_grad():
        logits, caches = model.prefill(params,
                                       {"tokens": torch.from_numpy(tk)}, MAX)
    n_mlstm = model.cfg.pattern.count("mlstm") * model.cfg.n_rep
    assert ops.DISPATCH_COUNTS["mlstm_chunk_ref"] \
        - before["mlstm_chunk_ref"] == n_mlstm
    jlogits, jcaches = jmodel.prefill(jparams, {"tokens": jnp.asarray(tk)},
                                      MAX)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **REF)
    _caches_close(caches, jcaches)


def _decode_alongside(model, params, caches, jmodel, jparams, jcaches,
                      jlogits, steps=3):
    """``steps`` greedy decode steps in both packages from their caches:
    logits and caches after each."""
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
        with torch.no_grad():
            logits, caches = model.decode_step(
                params, caches, {"token": torch.from_numpy(tok).long()})
        jlogits, jcaches = jmodel.decode_step(jparams, jcaches,
                                              {"token": jnp.asarray(tok)})
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **REF)
        _caches_close(caches, jcaches)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_from_reference_caches(arch):
    """Decode from the reference's own prefill caches, carried across."""
    jmodel, jparams = _reference(arch)
    model, params = _port(arch)
    jlogits, jcaches = jmodel.prefill(
        jparams, {"tokens": jnp.asarray(_tokens(3))}, MAX)
    caches = interop.lm_caches_from_reference(_flatten(jcaches), model.cfg,
                                              device=CPU)
    _decode_alongside(model, params, caches, jmodel, jparams, jcaches,
                      jlogits)


def test_sliding_window_ring_matches_reference():
    """A prompt longer than the window: the prefill leaves the last
    ``window`` keys in ring order, and decode writes on around the ring,
    as the reference's do (its ``test_prefill_swa_ring_exact``)."""
    _, jparams = _reference("smollm-135m")
    jmodel = JTransformer(dataclasses.replace(_jcfg("smollm-135m"),
                                              sliding_window=8))
    cfg = dataclasses.replace(_cfg("smollm-135m"), sliding_window=8)
    model = Transformer(cfg)
    params = interop.lm_params_from_reference(_flatten(jparams), cfg,
                                              device=CPU)
    tk = _tokens(5, n=20)
    with torch.no_grad():
        logits, caches = model.prefill(params,
                                       {"tokens": torch.from_numpy(tk)}, 32)
    jlogits, jcaches = jmodel.prefill(jparams, {"tokens": jnp.asarray(tk)}, 32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **REF)
    _caches_close(caches, jcaches)
    assert caches[0]["pos0"].k.shape[1] == 8
    _decode_alongside(model, params, caches, jmodel, jparams, jcaches,
                      jlogits)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_equals_decode_replay(arch):
    """The one-pass prefill and the token-by-token replay through
    ``decode_step`` leave the same last logits, and caches from which the
    next step agrees."""
    model, params = _port(arch)
    tk = torch.from_numpy(_tokens(4)).long()
    with torch.no_grad():
        logits_p, caches_p = model.prefill(params, {"tokens": tk}, MAX)
        caches_r = [{k: KVCache(c.k, c.v, torch.zeros_like(c.length))
                     if isinstance(c, KVCache) else c for k, c in rep.items()}
                    for rep in model.init_caches(B, MAX, device=CPU)]
        for t in range(S):
            logits_r, caches_r = model.decode_step(
                params, caches_r, {"token": tk[:, t:t + 1]})
        tol = dict(rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(logits_p, logits_r, **tol)
        tok = torch.argmax(logits_p, -1)[:, None]
        n1, _ = model.decode_step(params, caches_p, {"token": tok})
        n2, _ = model.decode_step(params, caches_r, {"token": tok})
        torch.testing.assert_close(n1, n2, **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_prefill_and_decode_matches_reference(arch):
    """``prefill_and_decode(temperature=0)`` on the CPU gives the JAX
    package's greedy tokens from the same weights and prompts (the
    reference draws both from ``PRNGKey(seed)``)."""
    P, G, seed = 32, 6, 0
    jcfg = _jcfg(arch)
    jgen, _ = jserve.prefill_and_decode(jcfg, batch=B, prompt_len=P,
                                        gen_tokens=G, seed=seed,
                                        temperature=0)
    _, params = _port(arch, seed)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (B, P),
                                            0, jcfg.vocab))
    gen, stats = tserve.prefill_and_decode(
        _cfg(arch), batch=B, prompt_len=P, gen_tokens=G, seed=seed,
        temperature=0, device="cpu", params=params, prompts=prompts)
    np.testing.assert_array_equal(gen, np.asarray(jgen))
    assert stats["logits_finite"]
    assert set(stats) == {"prefill_s", "decode_s", "tok_per_s",
                          "logits_finite"}


def test_replay_prefill_and_sampling():
    """``replay_prefill`` fills the caches through decode and gives the same
    greedy tokens; sampling at a temperature is reproducible from the seed
    and stays in the vocabulary."""
    cfg = _cfg("xlstm-1.3b")
    _, params = _port("xlstm-1.3b")
    kw = dict(batch=B, prompt_len=32, gen_tokens=5, device="cpu",
              params=params)
    one, _ = tserve.prefill_and_decode(cfg, temperature=0, **kw)
    rep, _ = tserve.prefill_and_decode(cfg, temperature=0,
                                       replay_prefill=True, **kw)
    np.testing.assert_array_equal(one, rep)
    s1, _ = tserve.prefill_and_decode(cfg, temperature=1.0, seed=3, **kw)
    s2, _ = tserve.prefill_and_decode(cfg, temperature=1.0, seed=3, **kw)
    np.testing.assert_array_equal(s1, s2)
    assert s1.shape == (B, 5) and ((s1 >= 0) & (s1 < cfg.vocab)).all()


def test_lm_caches_from_reference_keeps_kinds_and_dtypes():
    model = JTransformer(jget_smoke("xlstm-1.3b"))
    jcaches = model.init_caches(3, 16)
    caches = interop.lm_caches_from_reference(
        _flatten(jcaches), get_smoke_config("xlstm-1.3b"), device=CPU)
    assert len(caches) == 1
    C, n, m = caches[0]["pos0"]
    assert C.shape == (3, 4, 128, 128) and C.dtype == torch.float32
    assert caches[0]["pos1"].h.shape == (3, 4, 64)
    jkv = JTransformer(jget_smoke("smollm-135m")).init_caches(2, 16)
    assert isinstance(jkv["pos0"], JKVCache)
    kv = interop.lm_caches_from_reference(
        _flatten(jkv), get_smoke_config("smollm-135m"), device=CPU)
    assert len(kv) == 2 and kv[0]["pos0"].k.dtype == torch.bfloat16
    assert kv[0]["pos0"].length.dtype == torch.int32


def test_main_serves_an_lm_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "xlstm-1.3b", "--smoke", "--batch", "2",
        "--prompt-len", "32", "--gen", "3", "--device", "cpu"])
    tserve.main()
    out = capsys.readouterr().out
    assert "generated (2, 3) tokens" in out and "logits finite True" in out
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "hubert-xlarge",
                                     "--device", "cpu"])
    with pytest.raises(SystemExit, match="encoder-only"):
        tserve.main()
