"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA card (the kernels are built by nvcc at first use and launch
only on the device); every test skips without one.  Imports no JAX, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Encode and decode run the plain versions' own float32 operations in the
same order with no fused multiply-add, so they must agree exactly.  The
activation kernel sums each span's exponentials in lane order, PyTorch in
its own reduction order: atol 2e-6 on values in [-1, 1], and the hard
one-hots must be equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.segment_activations import \
    segment_activations_cuda  # noqa: E402
from repro_torch.kernels.vgm_decode import vgm_decode_table_cuda  # noqa: E402
from repro_torch.kernels.vgm_encode import vgm_encode_table_cuda  # noqa: E402
from torch_kernel_inputs import (ACT_LAYOUTS, activation_inputs,  # noqa: E402
                                 as_tensors, decode_inputs, encode_inputs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built by nvcc at "
                    "first use and launch only on the device")
    return torch.device("cuda", torch.cuda.current_device())


def _on(device, arrays):
    return [a.to(device) for a in as_tensors(*arrays)]


@pytest.mark.parametrize("N,Q,K,ks", [(4099, 5, 10, [10, 10, 7, 3, 10]),
                                      (1, 1, 1, [1]),
                                      (1000, 22, 10, [10] * 22)])
def test_vgm_encode_table_matches_plain(cuda, N, Q, K, ks):
    inputs = _on(cuda, encode_inputs(1, N, Q, K, ks))
    before = _build.DISPATCH_COUNTS["vgm_encode_table"]
    out = ops.vgm_encode_table(*inputs)
    torch.cuda.synchronize()
    assert _build.DISPATCH_COUNTS["vgm_encode_table"] == before + 1
    torch.testing.assert_close(out, tref.vgm_encode_table_ref(*inputs),
                               rtol=0, atol=0)


@pytest.mark.parametrize("N,Q,K,ks", [(4099, 5, 10, [10, 10, 7, 3, 10]),
                                      (3, 1, 1, [1])])
def test_vgm_decode_table_matches_plain(cuda, N, Q, K, ks):
    inputs = _on(cuda, decode_inputs(2, N, Q, K, ks))
    before = _build.DISPATCH_COUNTS["vgm_decode_table"]
    out = ops.vgm_decode_table(*inputs)
    torch.cuda.synchronize()
    assert _build.DISPATCH_COUNTS["vgm_decode_table"] == before + 1
    torch.testing.assert_close(out, tref.vgm_decode_table_ref(*inputs),
                               rtol=0, atol=0)


@pytest.mark.parametrize("layout", ["ctgan", "width1", "one_span"])
@pytest.mark.parametrize("hard", [False, True])
def test_segment_activations_matches_plain(cuda, layout, hard):
    px, pu, lay = activation_inputs(3, 4099, ACT_LAYOUTS[layout], 0.2)
    args = _on(cuda, (px, pu, lay.kinds))
    out = segment_activations_cuda(*args, 0.2, hard)
    torch.cuda.synchronize()
    plain = tref.segment_activations_ref(*args, 0.2, hard)
    torch.testing.assert_close(out, plain, rtol=0, atol=2e-6)
    if hard:
        soft = ~lay.pack_pad & (np.repeat(lay.kinds[:, 0], lay.wmax) < 0.5)
        soft = torch.as_tensor(soft, device=cuda)
        assert torch.equal(out[:, soft].round(), plain[:, soft].round())


def test_segment_activations_refuses_grad(cuda):
    px, pu, lay = activation_inputs(4, 16, ACT_LAYOUTS["ctgan"], 0.2)
    x, u, kinds = _on(cuda, (px, pu, lay.kinds))
    with pytest.raises(RuntimeError, match="requires grad"):
        segment_activations_cuda(x.requires_grad_(), u, kinds, 0.2)


def test_wrappers_check_shapes(cuda):
    x, means, stds, logw, g = _on(cuda, encode_inputs(5, 8, 2, 4, [4, 4]))
    with pytest.raises(ValueError, match="gumbel has shape"):
        vgm_encode_table_cuda(x, means, stds, logw, g[:, :-1])
    slots, m, s = _on(cuda, decode_inputs(5, 8, 2, 4, [4, 4]))
    with pytest.raises(TypeError, match="float32"):
        vgm_decode_table_cuda(slots.double(), m, s)
