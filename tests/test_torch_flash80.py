"""The port's flash attention at head dim 80, bidirectional -- hubert-xlarge's
shape (1280 / 16) -- held against the JAX package's on the CPU.

The same numpy-seeded q, k, v and upstream gradients go through JAX's
``flash_attention`` (its Pallas kernels in interpret mode, which take
any head dim) and the port's ``ops.flash_attention`` (the plain forward,
dq and dk/dv on the CPU; on the card the hd-80 instances of the float32
and the bf16 tensor-core libraries, ``tests/test_torch_cuda.py``).  Then
a hubert
smoke config widened to hd 80 (d_model 320, 4 heads) through the flash
route against the reference's plain route: logits and gradients.

Tolerances: the rule of ``tests/test_torch_flash.py`` -- float32 outputs
and lse rtol 1e-5, atol 1e-5, gradients rtol 1e-4, atol 1e-5 (the Pallas
kernel sums its online softmax 128 keys at a time, the plain version
over the whole row); bfloat16 outputs rtol 2^-7 (one bfloat16 ulp where
both round a float32 result across a boundary); model logits rtol 1e-5,
atol 2e-5, gradients rtol 1e-4 and atol 2e-5 of the leaf's largest
(``tests/test_torch_families_grad.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.kernels import flash_attention as jflash  # noqa: E402
from repro.models import Transformer as JTransformer  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import Transformer, tree_leaves  # noqa: E402
from repro_torch.models import tree_unflatten  # noqa: E402
from torch_families import as_reference  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

CASES = {  # B, H, Kh, Sq, Sk
    "ragged_200": (1, 2, 2, 200, 200),
    "gqa_128": (2, 4, 2, 128, 128),
}
HD = 80


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, H, Kh, Sq, Sk):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((B, H, Sq, HD), (B, Kh, Sk, HD), (B, Kh, Sk, HD),
             (B, H, Sq, HD))]


def test_head_dim_80_is_taken():
    """Both libraries have an hd-80 instance: the C entries get hd 80 and
    its scale."""
    assert 80 in tflash.HEAD_DIMS
    args = tflash._shape_args(2, 128, 128, 80, torch.bfloat16, False, None,
                              128)
    assert args[7:] == (80, 1)
    assert np.float32(args[6]) == np.float32(1.0 / np.sqrt(80.0))


@pytest.mark.parametrize("name", list(CASES))
def test_forward_and_gradients_match_jax(name):
    q, k, v, ct = _inputs(1, *CASES[name])

    def loss(q, k, v):
        out = jflash.flash_attention(q, k, v, causal=False, interpret=True)
        return jnp.sum(out * ct), out
    (_, want), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = ops.DISPATCH_COUNTS["flash_attention_ref"]
    out = ops.flash_attention(*leaves, causal=False)
    torch.sum(out * torch.from_numpy(ct)).backward()
    assert ops.DISPATCH_COUNTS["flash_attention_ref"] - before == 3
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for t, w in zip(leaves, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_lse_matches_jax_forward():
    """The padded (Sq 200 -> 256) bidirectional forward's log-sum-exp,
    the padded keys masked by the unpadded length."""
    q, k, v, _ = _inputs(2, *CASES["ragged_200"])
    q, k, v = (np.pad(a, ((0, 0), (0, 0), (0, 56), (0, 0))) for a in (q, k, v))
    j_out, j_lse = jflash._fwd_call(
        *(jnp.asarray(a) for a in (q, k, v)), causal=False, window=None,
        block_q=128, block_k=128, kv_len=200, interpret=True)
    t_out, t_lse = ref.flash_attention_fwd_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=False, window=None,
        kv_len=200)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-5,
                               atol=1e-5)


def test_bfloat16_matches_jax():
    q, k, v, _ = _inputs(3, *CASES["gqa_128"])
    want = jflash.flash_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        causal=False, interpret=True)
    got = ops.flash_attention(*(torch.from_numpy(a).bfloat16()
                                for a in (q, k, v)), causal=False)
    assert got.dtype == torch.bfloat16 and got.shape[-1] == HD
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)


def _hubert80(module):
    return dataclasses.replace(module("hubert-xlarge"), d_model=320,
                               n_heads=4, n_kv_heads=4, dtype="float32")


def test_hubert_at_head_dim_80_flash_route_matches_reference():
    """Frame inputs, bidirectional, hd 80, 2 layers: the port's flash
    route (remat on: per layer a forward, its recompute, dq and dk/dv)
    against the reference's plain route."""
    jcfg = _hubert80(jget_smoke)
    cfg = dataclasses.replace(_hubert80(get_smoke_config),
                              use_flash_kernel=True, remat=True)
    assert cfg.hd == 80
    jmodel = JTransformer(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = interop.lm_params_from_reference(_flatten(jparams), cfg,
                                              device="cpu")
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(2, 40, 320)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (2, 40), dtype=np.int32)
    jb = {"features": jnp.asarray(feats), "labels": jnp.asarray(labels)}
    tb = {"features": torch.from_numpy(feats),
          "labels": torch.from_numpy(labels).long()}
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, jb)
    jlogits, _ = jmodel.forward(jparams, jb)
    model = Transformer(cfg)
    before = ops.DISPATCH_COUNTS["flash_attention_ref"]
    loss, _ = model.loss(params, tb)
    grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True)
    assert ops.DISPATCH_COUNTS["flash_attention_ref"] - before \
        == 4 * cfg.n_layers
    with torch.no_grad():
        logits, _ = model.forward(params, tb)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, tree_leaves(params))]
    got = as_reference(tree_unflatten(params, grads))
    for key, want in _flatten(jgrads).items():
        np.testing.assert_allclose(got[key], want, rtol=1e-4,
                                   atol=2e-5 * np.abs(want).max(),
                                   err_msg=key)
