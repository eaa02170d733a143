"""The port's mixture-of-experts FFN held against the JAX package's on the
CPU: the same numpy-seeded inputs and the reference's own initial
parameters (its ``init_moe``) through ``repro.models.moe.moe_ffn`` and
``repro_torch.models.moe.moe_ffn``, top-1 and top-2, with capacity drops
active (capacity factor 0.5) and inactive (16, the capacity then rounded
up to 256), in float32.

Tolerances: outputs rtol 1e-5, atol 1e-6; aux loss and dropped fraction
rtol 1e-6 -- the same float32 router, softmax and products summed in
another order.  Discrete routing (the expert of every choice, which
choices fit the capacity, their slots) must be equal: the inputs are
continuous normal draws, so no two router probabilities tie.  Gradients
of ``sum(out * ct) + aux`` w.r.t. the input, the router and the expert
stacks against ``jax.grad``: rtol 1e-4, atol 1e-4 of the largest
gradient of the tensor -- at top-1 the renormalized gate is g / g, whose
gradient is rounding noise in both, and the router's gradient sums
those terms with the aux loss's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

B, S = 2, 24
CASES = {  # top_k, capacity factor
    "top1_drops": (1, 0.5), "top1_no_drops": (1, 16.0),
    "top2_drops": (2, 0.5), "top2_no_drops": (2, 16.0),
}
OUT = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(top_k, cf):
    kw = dict(d_model=64, d_ff=96, n_experts=4, top_k=top_k,
              capacity_factor=cf, dtype="float32")
    return (dataclasses.replace(jget_smoke("mixtral-8x22b"), **kw),
            dataclasses.replace(get_smoke_config("mixtral-8x22b"), **kw))


def _setup(name, seed=0):
    jcfg, cfg = _cfgs(*CASES[name])
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(seed).normal(size=(B, S, 64)).astype(np.float32)
    return jcfg, cfg, jp, tp, x


def _reference_routing(p, x, cfg):
    """The reference's routing steps (``moe.py:88-108``), which its
    ``moe_ffn`` keeps to itself: expert of each choice, keep, slot."""
    probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
    _, expert_idx = jax.lax.top_k(probs, cfg.top_k)
    cap = int(S * cfg.top_k / cfg.n_experts * cfg.capacity_factor) + 1
    if cap >= 128:
        cap = -(-cap // 128) * 128
    flat = expert_idx.reshape(B, S * cfg.top_k)
    onehot = jax.nn.one_hot(flat, cfg.n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=1) - onehot) * onehot, axis=2)
    keep = pos < cap
    dest = flat * cap + jnp.minimum(pos, cap - 1)
    return expert_idx, keep, dest, cap


@pytest.mark.parametrize("name", list(CASES))
def test_moe_ffn_matches_reference(name):
    jcfg, cfg, jp, tp, x = _setup(name)
    want, jm = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    got, m = tmoe.moe_ffn(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT)
    np.testing.assert_allclose(float(m.aux_loss), float(jm.aux_loss),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m.dropped_fraction),
                               float(jm.dropped_fraction), rtol=1e-6)
    r = tmoe.moe_route(tp, torch.from_numpy(x), cfg)
    j_idx, j_keep, j_dest, j_cap = _reference_routing(jp, jnp.asarray(x),
                                                      jcfg)
    assert r.cap == j_cap == tmoe.capacity(cfg, S)
    np.testing.assert_array_equal(r.expert_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(r.keep.numpy(), np.asarray(j_keep))
    np.testing.assert_array_equal(r.dest.numpy(), np.asarray(j_dest))
    dropped = float(m.dropped_fraction)
    assert dropped == 0.0 if "no_drops" in name else dropped > 0.1


@pytest.mark.parametrize("name", ["top1_drops", "top2_drops",
                                  "top2_no_drops"])
def test_moe_ffn_gradient_matches_reference(name):
    jcfg, cfg, jp, tp, x = _setup(name, seed=1)
    ct = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        out, m = jmoe.moe_ffn(p, xx, jcfg)
        return jnp.sum(out * ct) + m.aux_loss
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = [tp["router"], *tp["experts"].values()]
    xt = torch.from_numpy(x).requires_grad_()
    for t in leaves:
        t.requires_grad_()
    out, m = tmoe.moe_ffn(tp, xt, cfg)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(ct))
                                + m.aux_loss, [xt, *leaves])
    want = [jgx, jgp["router"], *jgp["experts"].values()]
    for name_, g, w in zip(["x", "router", *tp["experts"]], grads, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name_)


def test_capacity_rounds_up_past_128():
    _, cfg = _cfgs(2, 1.25)
    assert tmoe.capacity(cfg, 24) == int(24 * 2 / 4 * 1.25) + 1 == 16
    assert tmoe.capacity(cfg, 256) == 256       # int(160) + 1 -> 256
    one_token = dataclasses.replace(get_smoke_config("mixtral-8x22b"))
    assert tmoe.capacity(one_token, 1) == 1     # decode: top-2 of 4, cap 1


def test_init_moe_keys_shapes_and_dtypes_match_reference():
    jcfg, cfg = _cfgs(2, 1.25)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    jflat = dict(jax.tree_util.tree_leaves_with_path(jp))
    tflat = {("router",): tp["router"],
             **{("experts", k): v for k, v in tp["experts"].items()}}
    assert len(jflat) == len(tflat) == 4
    for path, leaf in jflat.items():
        key = tuple(k.key for k in path)
        assert tuple(tflat[key].shape) == leaf.shape, key
        want = torch.float32 if key == ("router",) else torch.bfloat16
        assert tflat[key].dtype == want, key
    # drawn per expert at scale 1/sqrt(fan_in): unit variance after it
    w = tp["experts"]["w_gate"].float() * 64 ** 0.5
    assert abs(float(w.std()) - 1.0) < 0.05
