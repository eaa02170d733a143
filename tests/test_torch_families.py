"""The port's ``Transformer`` over every block and input kind held
against the JAX package on the CPU: the smoke configs of mixtral-8x22b
(MoE, sliding window), llama4-maverick (a dense and an MoE FFN, top-1),
jamba (Mamba, attention, MoE every second FFN), llama-3.2-vision
(gated cross-attention onto vision embeddings) and hubert-xlarge (frame
inputs, bidirectional), in float32, from the reference's parameters with
the cross-attention gates at 0.7 (``tests/torch_families.py``).  The
gradients are in ``tests/test_torch_families_grad.py``, the serving path
in ``tests/test_torch_families_serve.py``.

Tolerances: logits rtol 1e-5, atol 2e-5 and the loss rtol 1e-5 (the rule
of ``tests/test_torch_lm.py``: float32 products summed in another order,
through up to 8 layers); the MoE aux loss rtol 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import Transformer as JTransformer  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import Transformer, tree_items  # noqa: E402
from torch_families import (CPU, FAMILIES, batches, inputs,  # noqa: E402
                            port, reference)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

B, S = 2, 16


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_config_builds(arch):
    """No config of the repo is refused."""
    assert Transformer(get_config(arch)).cfg.name == arch


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_matches_the_reference_tree(arch):
    """The bf16 smoke config's parameters: the reference's keys, shapes
    (the port's per-repetition leaves stacked) and float32 leaves."""
    shapes = jax.eval_shape(JTransformer(jget_smoke(arch)).init,
                            jax.random.PRNGKey(0))
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    params = Transformer(get_smoke_config(arch)).init(seed=0, device=CPU)
    got: dict = {}
    for path, t in tree_items(params):
        parts = path.split("/")
        key = "/".join(["layers"] + parts[2:]) if parts[0] == "layers" \
            else path
        got.setdefault(key, []).append(t)
    assert set(got) == set(want)
    for key, leaf in want.items():
        ts = got[key]
        shape = (len(ts), *ts[0].shape) if key.startswith("layers") \
            else tuple(ts[0].shape)
        assert shape == leaf.shape, key
        assert ts[0].dtype == (torch.float32 if leaf.dtype == jnp.float32
                               else torch.bfloat16), key
        assert all(t.requires_grad for t in ts), key


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_and_loss_match_reference(arch):
    jmodel, jparams = reference(arch)
    model, params = port(arch)
    jb, tb = batches(arch, inputs(arch, 3, B, S))
    want_logits, want_aux = jmodel.forward(jparams, jb)
    want_loss, want_m = jmodel.loss(jparams, jb)
    with torch.no_grad():
        logits, aux = model.forward(params, tb)
        loss, m = model.loss(params, tb)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(m["ce"]), float(want_m["ce"]),
                               rtol=1e-5)
    assert (float(aux) > 0) == (model.cfg.n_experts > 0)
