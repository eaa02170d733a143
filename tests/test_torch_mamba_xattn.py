"""The port's Mamba block and cross-attention block held against the JAX
package's on the CPU: the same numpy-seeded inputs and the reference's
own initial parameters, in float32 (the jamba and llama-3.2-vision smoke
configs' widths: d_model 256, Mamba d_inner 512, state 16, conv 4;
cross-attention 8 query and 2 KV heads of 32 onto 16 vision tokens).

Tolerances: block outputs and the Mamba state rtol 1e-5, atol 1e-5 -- the
same float32 formulas (the selective scan step by step in the same
order), products summed in another order.  The decode window is
bfloat16 in both packages, as the reference keeps it: where a float32
input agrees to ~1e-7 but straddles a bfloat16 rounding boundary the two
windows sit one bfloat16 ulp apart (rtol 2^-7, atol 1e-5), and the step
that reads such a window moves by up to that ulp times the tap's weight:
decode outputs atol 2e-4 (measured: ~1e-5 without a flip).  The gated
cross-attention residual ``tanh(0.7) * block`` rtol 1e-5, atol 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

B = 2
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return (dataclasses.replace(jget_smoke(arch), dtype="float32"),
            dataclasses.replace(get_smoke_config(arch), dtype="float32"))


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _mamba(seed=0):
    jcfg, cfg = _cfgs("jamba-1.5-large-398b")
    jp = jssm.init_mamba(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jcfg, cfg, jp, _torch_tree(jp)


def _x(seed, S, D=256):
    return np.random.default_rng(seed).normal(size=(B, S, D)).astype(
        np.float32)


@pytest.mark.parametrize("S", [2, 3, 24])
def test_mamba_block_and_state_match_reference(S):
    """S < k-1, S = k-1 and a longer sequence: the output and the state
    after the last token (h, and the last k-1 inputs, zero-padded in
    front when fewer)."""
    jcfg, cfg, jp, tp = _mamba()
    x = _x(1, S)
    want, jstate = jssm.mamba_block(jp, jnp.asarray(x), jcfg,
                                    return_state=True)
    got, state = tssm.mamba_block(tp, torch.from_numpy(x), cfg,
                                  return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(state.h.numpy(), np.asarray(jstate.h), **TOL)
    assert state.conv_buf.dtype == torch.bfloat16
    assert state.conv_buf.shape == jstate.conv_buf.shape
    np.testing.assert_allclose(state.conv_buf.float().numpy(),
                               np.asarray(jstate.conv_buf, np.float32),
                               rtol=2 ** -7, atol=1e-5)
    np.testing.assert_allclose(
        tssm.mamba_block(tp, torch.from_numpy(x), cfg).numpy(),
        got.numpy(), rtol=0, atol=0)


def test_mamba_causal_conv_matches_reference():
    _, _, jp, tp = _mamba()
    u = _x(2, 9, 512)
    np.testing.assert_allclose(
        tssm._causal_conv(torch.from_numpy(u), tp["ssm_conv"]).numpy(),
        np.asarray(jssm._causal_conv(jnp.asarray(u), jp["ssm_conv"])),
        **TOL)


def test_mamba_decode_matches_reference():
    """A prefill of 10 tokens, then 4 ``mamba_decode`` steps in each
    package from the same state (the reference's, carried across)."""
    jcfg, cfg, jp, tp = _mamba(seed=3)
    x = _x(4, 14)
    _, jstate = jssm.mamba_block(jp, jnp.asarray(x[:, :10]), jcfg,
                                 return_state=True)
    state = tssm.MambaState(torch.from_numpy(np.array(jstate.h)),
                            torch.from_numpy(np.array(
                                jstate.conv_buf, np.float32)).bfloat16())
    for t in range(10, 14):
        xt = x[:, t:t + 1]
        want, jstate = jssm.mamba_decode(jp, jnp.asarray(xt), jstate, jcfg)
        got, state = tssm.mamba_decode(tp, torch.from_numpy(xt), state, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=2e-4)
        np.testing.assert_allclose(state.h.numpy(), np.asarray(jstate.h),
                                   rtol=1e-5, atol=2e-4)
        np.testing.assert_allclose(state.conv_buf.float().numpy(),
                                   np.asarray(jstate.conv_buf, np.float32),
                                   rtol=2 ** -7, atol=1e-5)
        assert state.conv_buf.dtype == torch.bfloat16


def test_mamba_init_keys_shapes_and_dtypes_match_reference():
    jcfg, cfg = _cfgs("jamba-1.5-large-398b")
    jp = jssm.init_mamba(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    tp = tssm.init_mamba(torch.Generator().manual_seed(0), cfg,
                         torch.bfloat16)
    assert set(tp) == set(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape, k
        assert tp[k].dtype == (torch.float32 if v.dtype == jnp.float32
                               else torch.bfloat16), k
    for k in ("ssm_d", "ssm_dt_bias"):               # deterministic leaves
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    # log(1..16): the two packages' logs may round one float32 ulp apart
    np.testing.assert_allclose(tp["ssm_a"].numpy(), np.asarray(jp["ssm_a"]),
                               rtol=2 ** -23, atol=0)


def _xattn(seed=0):
    jcfg, cfg = _cfgs("llama-3.2-vision-11b")
    jp = jattn.init_attention(jax.random.PRNGKey(seed), jcfg, jnp.float32,
                              cross=True)
    return jcfg, cfg, jp, _torch_tree(jp)


@pytest.mark.parametrize("Sq", [1, 20])
def test_cross_attention_block_matches_reference(Sq):
    """Onto 16 vision tokens; Sq 1 is the decode step's call."""
    jcfg, cfg, jp, tp = _xattn()
    x, vision = _x(5, Sq), _x(6, cfg.xattn_tokens)
    want = jattn.cross_attention_block(jp, jnp.asarray(x),
                                       jnp.asarray(vision), cfg=jcfg)
    got = tattn.cross_attention_block(tp, torch.from_numpy(x),
                                      torch.from_numpy(vision), cfg=cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gated_cross_attention_residual():
    """The model's gated residual ``y * tanh(gate)`` at gate 0.7 against
    the reference block times tanh(0.7); at the initial gate 0 it adds
    exactly nothing."""
    jcfg, cfg, jp, tp = _xattn(seed=1)
    x, vision = _x(7, 8), _x(8, cfg.xattn_tokens)
    want = jattn.cross_attention_block(jp, jnp.asarray(x),
                                       jnp.asarray(vision), cfg=jcfg) \
        * jnp.tanh(jnp.float32(0.7))
    model = Transformer(cfg)
    blk = {"attn": tp, "xattn_gate": torch.tensor(0.7)}
    got = model._cross(blk, torch.from_numpy(x), torch.from_numpy(vision))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    off = model._cross(dict(blk, xattn_gate=torch.tensor(0.0)),
                       torch.from_numpy(x), torch.from_numpy(vision))
    assert float(off.abs().max()) == 0.0
