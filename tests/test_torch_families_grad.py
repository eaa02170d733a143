"""Gradients of the port's ``Transformer`` loss held against ``jax.grad``
of the JAX package's on the CPU, for the smoke configs of the five
families of ``tests/torch_families.py`` (MoE, Mamba, cross-attention,
frame inputs), in float32, through ``make_train_step`` with remat on.

Tolerances: rtol 1e-4 and atol 2e-5 of the leaf's largest gradient -- at
random init through 8 layers the gradients reach ~3 (jamba's embedding)
and the two packages' differ by up to ~1e-5 of a leaf's largest -- or
1e-4 of it for the MoE routers, whose top-1 gate is g / g, a gradient of
rounding noise in both.  A leaf the loss does not read (hubert's
output-class table) has gradient exactly 0 in both.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro_torch.models import (TrainState, Transformer,  # noqa: E402
                                make_train_step, tree_unflatten)
from torch_families import (FAMILIES, as_reference, batches,  # noqa: E402
                            inputs, port, reference)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

B, S = 2, 16


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_gradients_match_reference(arch):
    """Through ``make_train_step`` with remat on, as training runs: every
    layer under ``torch.utils.checkpoint``."""
    jmodel, jparams = reference(arch)
    jb, tb = batches(arch, inputs(arch, 4, B, S))
    (_, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, jb)
    model, params = port(arch)
    model = Transformer(dataclasses.replace(model.cfg, remat=True))
    state = TrainState(params, _NoStep(), 0)
    make_train_step(model, _NoStep())(state, tb)
    got = as_reference(tree_unflatten(params, _NoStep.grads))
    want = _flatten(jgrads)
    assert set(got) == set(want)
    for key in want:
        top = np.abs(want[key]).max()
        atol = (1e-4 if key.endswith("router") else 2e-5) * top
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=atol, err_msg=key)


class _NoStep:
    """An optimizer that keeps the gradients of ``make_train_step`` and
    changes nothing."""
    grads: list = []

    def update(self, grads, opt_state, leaves):
        _NoStep.grads = list(grads)
        return opt_state
