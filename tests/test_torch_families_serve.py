"""The port's serving path over every block and input kind --
``Transformer.prefill`` and ``decode_step`` with the KV caches, the Mamba
state and the cross-attention placeholder -- held against the JAX
package on the CPU, for the smoke configs of the five families of
``tests/torch_families.py``, in float32: a prefill, then 3 greedy
``decode_step``s from the port's own caches and from the reference's
carried across by ``lm_caches_from_reference``.  The MoE's one-token
decode has capacity 1 per expert and never drops (top-2 of 4 or top-1).

Tolerances: logits and caches rtol 2e-5, atol 2e-5 (the rule of
``tests/test_torch_lm_serve.py``); the bfloat16 Mamba window rtol 2^-7
(one bfloat16 ulp, where the float32 inputs it rounds straddle a rounding
boundary) and atol 2e-5 (those inputs' own tolerance, for values near
0).  With Mamba (jamba), decode logits and states (the window's atol
too) rtol 5e-3, atol 5e-3:
every step rounds each layer's new input to the bfloat16 window, where
inputs that agree to ~1e-7 may land one bfloat16 ulp apart, and 7 Mamba
layers carry such flips forward (measured: 1.4e-3 after 3 steps from the
port's own caches, 1.9e-4 after one from the reference's; a single
layer's step within 2e-4, ``tests/test_torch_mamba_xattn.py``).  Greedy
tokens: equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models.ssm import MambaState  # noqa: E402
from torch_families import CPU, FAMILIES, inputs, port, reference  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

B, S, MAX, STEPS = 2, 12, 20, 3
REF = dict(rtol=2e-5, atol=2e-5)
MAMBA = dict(rtol=5e-3, atol=5e-3)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _caches_close(got, jcaches, tol=REF):
    want = _flatten(jcaches)
    for r, rep in enumerate(got):
        for pos, state in rep.items():
            if isinstance(state, torch.Tensor):      # cross-attention
                np.testing.assert_array_equal(state.numpy(), want[pos][r])
                assert state.dtype == torch.int32
                continue
            for field, t in zip(state._fields, state, strict=True):
                leaf_tol = (dict(rtol=2 ** -7, atol=max(tol["atol"], 2e-5))
                            if t.dtype == torch.bfloat16 else tol)
                np.testing.assert_allclose(
                    t.float().numpy(), want[f"{pos}/.{field}"][r], **leaf_tol,
                    err_msg=f"rep {r} {pos} {field}")


def _step_inputs(arch, model, arrays, tok, t):
    """The decode step's batch in both packages: the greedy token, or
    for frame inputs the prompt's frame t; and the vision embeddings."""
    jb, tb = {}, {}
    if model.cfg.embed_inputs:
        jb["token"] = jnp.asarray(tok)
        tb["token"] = torch.from_numpy(tok).long()
    else:
        f = arrays["decode_features"][:, t:t + 1]
        jb["features"], tb["features"] = jnp.asarray(f), torch.from_numpy(f)
    if "vision" in arrays:
        jb["vision"] = jnp.asarray(arrays["vision"])
        tb["vision"] = torch.from_numpy(arrays["vision"])
    return jb, tb


def _prompt(arch, model, arrays):
    jb, tb = {}, {}
    key = "tokens" if model.cfg.embed_inputs else "features"
    jb[key] = jnp.asarray(arrays[key])
    tb[key] = torch.from_numpy(arrays[key])
    if key == "tokens":
        tb[key] = tb[key].long()
    if "vision" in arrays:
        jb["vision"] = jnp.asarray(arrays["vision"])
        tb["vision"] = torch.from_numpy(arrays["vision"])
    return jb, tb


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_reference(arch):
    jmodel, jparams = reference(arch)
    model, params = port(arch)
    arrays = inputs(arch, 5, B, S)
    arrays["decode_features"] = np.random.default_rng(6).normal(
        size=(B, STEPS, model.cfg.d_model)).astype(np.float32)
    jb, tb = _prompt(arch, model, arrays)
    jlogits, jcaches = jmodel.prefill(jparams, jb, MAX)
    with torch.no_grad():
        logits, caches = model.prefill(params, tb, MAX)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **REF)
    _caches_close(caches, jcaches)
    carried = interop.lm_caches_from_reference(_flatten(jcaches), model.cfg,
                                               device=CPU)
    dec = MAMBA if "mamba" in model.cfg.pattern else REF
    for t in range(STEPS):
        tok = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
        if model.cfg.embed_inputs:
            assert np.array_equal(tok[:, 0], logits.argmax(-1).numpy())
        jstep, tstep = _step_inputs(arch, model, arrays, tok, t)
        with torch.no_grad():
            logits, caches = model.decode_step(params, caches, tstep)
            from_ref, carried = model.decode_step(params, carried, tstep)
        jlogits, jcaches = jmodel.decode_step(jparams, jcaches, jstep)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **dec)
        np.testing.assert_allclose(from_ref.numpy(), np.asarray(jlogits),
                                   **dec)
        _caches_close(caches, jcaches, dec)
        _caches_close(carried, jcaches, dec)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b",
                                  "llama-3.2-vision-11b"])
def test_caches_keep_kinds_and_dtypes(arch):
    """``init_caches`` and ``lm_caches_from_reference``: the Mamba state's
    float32 h and bfloat16 window, the cross-attention (B,) int32
    placeholder, the KV cache in the model's dtype."""
    jmodel, _ = reference(arch)
    model, _ = port(arch)
    from_ref = interop.lm_caches_from_reference(
        _flatten(jmodel.init_caches(3, 16)), model.cfg, device=CPU)
    own = model.init_caches(3, 16, device=CPU)
    assert len(from_ref) == len(own) == model.cfg.n_rep
    for a, b in zip(from_ref, own):
        assert set(a) == set(b) == {f"pos{i}" for i in
                                    range(len(model.cfg.pattern))}
        for pos, kind in enumerate(model.cfg.pattern):
            x, y = a[f"pos{pos}"], b[f"pos{pos}"]
            if kind == "xattn":
                assert x.shape == y.shape == (3,)
                assert x.dtype == y.dtype == torch.int32
            elif kind == "mamba":
                assert isinstance(x, MambaState) and isinstance(y, MambaState)
                di = model.cfg.d_model * model.cfg.ssm_expand
                assert x.h.shape == y.h.shape == (3, di, model.cfg.ssm_state)
                assert x.h.dtype == y.h.dtype == torch.float32
                assert x.conv_buf.shape == (3, model.cfg.ssm_conv - 1, di)
                assert x.conv_buf.dtype == y.conv_buf.dtype == torch.bfloat16
            else:
                assert x.k.dtype == y.k.dtype == torch.float32
