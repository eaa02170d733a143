"""The port's entry points on the CPU for frame inputs (hubert-xlarge) and
cross-attention (llama-3.2-vision), at their smoke configs in float32,
held against the JAX package where it has the same entry: training
through ``run_centralized`` from the reference's parameters on the
reference's own stubbed-frontend draws (injected through ``make_batch``),
hubert's federated round through ``run_federated`` on the flash route,
and greedy serving through ``prefill_and_decode`` with the vision
embeddings at the prefill and at every decode step.

Tolerances: losses rtol 1e-4; parameters after Adam atol lr per step
taken and 99% of the elements within 2e-6 (the rule of
``tests/test_torch_lm.py``: Adam turns rounding-level gradient noise into
steps of up to lr); greedy tokens equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import Transformer as JTransformer  # noqa: E402
from repro.models import make_serve_step as jmake_serve_step  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import tree_leaves  # noqa: E402
from torch_families import (CPU, as_reference, cfg, jcfg, port,  # noqa: E402
                            reference)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ARCHS = ["hubert-xlarge", "llama-3.2-vision-11b"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_frontends(arch, seed, batch, seq):
    """The reference's ``_batch_dict`` draws (one key for every step:
    ``PRNGKey(seed)``) as float32 numpy arrays."""
    b = jtrain._batch_dict(jcfg(arch), np.zeros((batch, seq), np.int32),
                           jax.random.PRNGKey(seed))
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in b.items()
            if k in ("features", "vision")}


@pytest.mark.parametrize("arch", ARCHS)
def test_run_centralized_matches_reference(arch):
    lr, kw = 1e-3, dict(steps=2, batch=2, seq=16, seed=1, log_every=1)
    jstate, jhist = jtrain.run_centralized(jcfg(arch), lr=lr, **kw)
    # the reference's run starts from its own init (gates at 0)
    params = interop.lm_params_from_reference(
        _flatten(JTransformer(jcfg(arch)).init(jax.random.PRNGKey(1))),
        cfg(arch), device=CPU)
    extras = _reference_frontends(arch, 1, 2, 16)

    def make_batch(tokens):
        b = {"labels": torch.from_numpy(tokens).long()}
        if cfg(arch).embed_inputs:
            b["tokens"] = b["labels"]
        b.update({k: torch.from_numpy(v) for k, v in extras.items()})
        return b
    state, hist = ttrain.run_centralized(cfg(arch), lr=lr, device=CPU,
                                         init_params=params,
                                         make_batch=make_batch, **kw)
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], rtol=1e-4)
    got, want = as_reference(state.params), _flatten(jstate.params)
    assert set(got) == set(want)
    diffs = np.concatenate([np.abs(got[k] - np.asarray(want[k], np.float32)
                                   ).reshape(-1) for k in want])
    assert diffs.max() <= lr * kw["steps"], diffs.max()
    assert np.mean(diffs <= 2e-6) >= 0.99


def test_hubert_federated_round_on_the_flash_route():
    """2 clients x 1 round x 2 local steps: per step 4 plain flash calls a
    layer under remat (forward, recompute, dq, dk/dv), one merge; finite
    losses, clients equal after the merge, the output-class table (read
    by no loss) unchanged but for the merge's rounding."""
    c = dataclasses.replace(cfg("hubert-xlarge"), use_flash_kernel=True,
                            remat=True)
    _, params = port("hubert-xlarge")
    embed0 = params["embed"].detach().clone()
    with ops.dispatch_scope() as d:
        states, hist, w = ttrain.run_federated(
            c, clients=2, rounds=1, local_steps=2, batch=2, seq=16, lr=1e-3,
            device=CPU, init_params=params)
    assert dict(d) == {"flash_attention_ref": 2 * 2 * 4 * c.n_layers,
                       "weighted_agg_ref": 1}
    assert np.isfinite(hist[0]["loss"]) and abs(float(w.sum()) - 1) < 1e-6
    for a, b in zip(tree_leaves(states[0].params),
                    tree_leaves(states[1].params)):
        assert torch.equal(a, b)
    # zero gradients, zero Adam steps: the merge's weighted mean of equal
    # values rounds it by at most an ulp
    torch.testing.assert_close(states[0].params["embed"].detach(), embed0,
                               rtol=2 ** -23, atol=0)


def test_batch_maker_draws_the_stubbed_frontends():
    tokens = np.arange(2 * 5, dtype=np.int32).reshape(2, 5) % 64
    b = ttrain.batch_maker(cfg("hubert-xlarge"), CPU, seed=3)(tokens)
    assert set(b) == {"features", "labels"}
    assert b["features"].shape == (2, 5, 256)
    assert b["features"].dtype == torch.bfloat16
    v = ttrain.batch_maker(cfg("llama-3.2-vision-11b"), CPU, seed=3)
    b1, b2 = v(tokens), v(tokens)
    assert set(b1) == {"tokens", "labels", "vision"}
    assert b1["vision"].shape == (2, 16, 256)
    assert not torch.equal(b1["vision"], b2["vision"])    # drawn anew
    again = ttrain.batch_maker(cfg("llama-3.2-vision-11b"), CPU, seed=3)
    assert torch.equal(again(tokens)["vision"], b1["vision"])


def test_vision_prefill_and_decode_matches_reference():
    """Greedy: the reference's prefill and decode steps (jitted, as its
    ``prefill_and_decode`` runs them) from the same parameters, prompts
    and vision embeddings, gates at 0.7."""
    arch, B, P, G = "llama-3.2-vision-11b", 2, 12, 4
    jmodel, jparams = reference(arch)
    _, params = port(arch)
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, 512, (B, P), dtype=np.int32)
    vision = rng.normal(size=(B, 16, 256)).astype(np.float32)
    extras = {"vision": jnp.asarray(vision)}
    logits, caches = jax.jit(lambda p, b: jmodel.prefill(p, b, P + G))(
        jparams, {"tokens": jnp.asarray(prompts), **extras})
    serve = jax.jit(jmake_serve_step(jmodel))
    tok, want = jnp.argmax(logits, -1)[:, None], []
    for _ in range(G):
        logits, caches = serve(jparams, caches, {"token": tok, **extras})
        tok = jnp.argmax(logits, -1)[:, None]
        want.append(np.asarray(tok[:, 0]))
    gen, stats = tserve.prefill_and_decode(
        cfg(arch), batch=B, prompt_len=P, gen_tokens=G, temperature=0,
        device=CPU, params=params, prompts=prompts,
        vision=torch.from_numpy(vision))
    np.testing.assert_array_equal(gen, np.stack(want, axis=1))
    assert stats["logits_finite"]


def test_mains_run_the_new_families_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "llama-3.2-vision-11b", "--smoke", "--batch", "2",
        "--prompt-len", "8", "--gen", "2", "--device", "cpu"])
    tserve.main()
    out = capsys.readouterr().out
    assert "generated (2, 2) tokens" in out and "logits finite True" in out
    for arch in ("hubert-xlarge", "jamba-1.5-large-398b"):
        ttrain.main(["--arch", arch, "--smoke", "--federated", "--clients",
                     "2", "--rounds", "1", "--local-steps", "1", "--batch",
                     "1", "--seq", "8", "--device", "cpu"])
        assert "round    1 mean-loss" in capsys.readouterr().out
