"""The chunkwise mLSTM's backward on the CPU: the plain version of the
backward kernel (``kernels/ref.py:mlstm_chunk_bwd_plain``), the route
``ops.mlstm_chunk`` takes under autograd (``MLSTMChunk``) and its count,
held against the JAX package's per-step oracle and against autograd.
Inputs are drawn with numpy as the reference's kernel tests draw them;
one torch thread.

Tolerances, each gradient within a fraction of the largest |entry| of
the gradient it is held to: each entry is a cancelling sum of many terms,
which rounds at the scale of its largest terms, not of the result.
dlog_f sums the same terms as dlog_i (each gated score's gradient enters
both), so its scale is the larger of the two: under strong decay its own
largest entry is ~1e-12 while its terms are O(1).
  * against ``jax.vjp`` of the reference's per-step oracle
    (``src/repro/kernels/ref.py:mlstm_chunk_ref``): 2e-5 (measured
    <= 3.5e-6): the chunkwise and per-step forms take their stabilizers
    at other steps, as the forwards' own 2e-3 gate says.
  * against ``torch.autograd.grad`` through ``mlstm_chunk_plain``: 5e-6
    (measured <= 6e-7): the same chunkwise formulas, except that autograd
    also walks the stabilizers' paths, which cancel to rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, work  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.mlstm_chunk import mlstm_chunk_bwd_cuda  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from torch_kernel_inputs import as_tensors, mlstm_inputs  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

CASES = [  # BH, S, hd, chunk, constant log_f: test_torch_ssm.py's shapes
    (2, 64, 32, 16, None), (4, 128, 64, 32, None), (1, 256, 128, 128, None),
    (3, 96, 16, 32, None),
    (1, 32, 16, 16, -30.0),      # strong decay: the state resets every step
]
NAMES = ("dq", "dk", "dv", "dlog_f", "dlog_i")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case):
    BH, S, hd, chunk, log_f = case
    arrays = mlstm_inputs(BH * S + hd, BH, S, hd, log_f=log_f)
    dh = np.random.default_rng(BH + S).normal(size=(BH, S, hd)
                                              ).astype(np.float32)
    return arrays, dh, chunk


def _close(got, want, frac):
    got = [np.asarray(g.detach() if isinstance(g, torch.Tensor) else g)
           for g in got]
    want = [np.asarray(w.detach() if isinstance(w, torch.Tensor) else w)
            for w in want]
    scales = [float(np.abs(w).max()) for w in want]
    scales[3] = max(scales[3], scales[4])
    for g, w, s, name in zip(got, want, scales, NAMES):
        assert g.shape == w.shape and g.dtype == np.float32, name
        err = float(np.abs(g - w).max())
        assert err <= frac * s, (name, err, s)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_vjp_of_the_oracle(case):
    arrays, dh, chunk = _inputs(case)
    _, vjp = jax.vjp(jref.mlstm_chunk_ref, *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(dh))
    got = tref.mlstm_chunk_bwd_plain(*as_tensors(*arrays),
                                     torch.from_numpy(dh), chunk=chunk)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_autograd_through_the_plain_forward(case):
    arrays, dh, chunk = _inputs(case)
    leaves = [t.requires_grad_() for t in as_tensors(*arrays)]
    want = torch.autograd.grad(tref.mlstm_chunk_plain(*leaves, chunk=chunk),
                               leaves, torch.from_numpy(dh))
    got = tref.mlstm_chunk_bwd_plain(*as_tensors(*arrays),
                                     torch.from_numpy(dh), chunk=chunk)
    _close(got, want, 5e-6)


def test_ops_under_autograd_takes_the_plain_backward():
    """On the CPU, ``ops.mlstm_chunk`` under autograd runs the plain
    forward once and the plain backward once, and its gradient is the
    plain backward's, bit for bit; without grad it records no graph."""
    arrays, dh, chunk = _inputs(CASES[1])
    leaves = [t.requires_grad_() for t in as_tensors(*arrays)]
    with ops.dispatch_scope() as calls:
        h = ops.mlstm_chunk(*leaves, chunk=chunk)
        grads = torch.autograd.grad(h, leaves, torch.from_numpy(dh))
    assert dict(calls) == {"mlstm_chunk_ref": 1, "mlstm_chunk_bwd_ref": 1}
    want = tref.mlstm_chunk_bwd_plain(*as_tensors(*arrays),
                                      torch.from_numpy(dh), chunk=chunk)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    assert torch.equal(h.detach(), tref.mlstm_chunk_plain(
        *as_tensors(*arrays), chunk=chunk))
    with torch.no_grad():
        assert ops.mlstm_chunk(*leaves, chunk=chunk).grad_fn is None


def test_a_gradient_into_the_final_state_is_refused():
    """The final (C, n, m) is returned but not differentiated: h takes its
    gradient, and a gradient that reaches the state raises."""
    arrays, _, chunk = _inputs(CASES[0])
    leaves = [t.requires_grad_() for t in as_tensors(*arrays)]
    h, (C, n, m) = ops.mlstm_chunk(*leaves, chunk=chunk, return_state=True)
    assert torch.autograd.grad(h.sum(), leaves[0])[0].shape == h.shape
    for i in range(3):
        _, state = ops.mlstm_chunk(*leaves, chunk=chunk, return_state=True)
        with pytest.raises(NotImplementedError, match="final state"):
            torch.autograd.grad(state[i].sum(), leaves[0])


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    arrays, dh, chunk = _inputs(CASES[0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        mlstm_chunk_bwd_cuda(*as_tensors(*arrays), torch.from_numpy(dh),
                             chunk=chunk)


def test_least_work_of_the_backward():
    """Five state products of 2 L hd^2 over every chunk past the first and
    five causal halves of L (L + 1) hd a chunk; q, k, v, dh and the gates
    in, the five gradients out."""
    BH, S, hd, L = 16, 512, 1024, 256
    n_bytes, flops = work.mlstm_chunk_bwd(BH, S, hd, L)
    assert flops == BH * (5 * 2 * L * hd * hd + 2 * 5 * L * (L + 1) * hd)
    assert flops == 53_729_034_240
    assert n_bytes == 4 * (7 * BH * S * hd + 4 * BH * S)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_counted_work_is_launches_times_least_work(device):
    """An mLSTM layer's forward and gradient under the counter, on the CPU
    and on meta alike: one ``mlstm_chunk`` and one ``mlstm_chunk_bwd``
    launch, each with its least work, and no op beneath them counted."""
    BH, S, hd, chunk = 4, 64, 32, 16
    arrays = [t.to(device).requires_grad_()
              for t in as_tensors(*mlstm_inputs(0, BH, S, hd))]

    def step(*leaves):
        h = ops.mlstm_chunk(*leaves, chunk=chunk)
        return torch.autograd.grad(h.sum(), leaves)
    got = roofline.count_ops(step, *arrays)
    for name, fn in (("mlstm_chunk", work.mlstm_chunk),
                     ("mlstm_chunk_bwd", work.mlstm_chunk_bwd)):
        n_bytes, flops = fn(BH, S, hd, chunk)
        assert got.kernels[name] == {"launches": 1, "flops": flops,
                                     "bytes": n_bytes}
    assert set(got.kernels) == {"mlstm_chunk", "mlstm_chunk_bwd"}


def _count_train_step(cfg, device, B, S):
    from repro_torch.models import (TrainState, Transformer, make_train_step,
                                    tree_leaves)
    from repro_torch.optim import adam
    model = Transformer(cfg)
    opt = adam(1e-3, b1=0.9, b2=0.95, moment_dtype=torch.float32)
    params = model.init(seed=0, device=device)
    state = TrainState(params, opt.init(tree_leaves(params)), 0)
    toks = torch.zeros((B, S), dtype=torch.int32, device=device)
    return roofline.count_ops(make_train_step(model, opt), state,
                              {"tokens": toks, "labels": toks})


@pytest.mark.parametrize("pattern", [("mlstm", "slstm"), ("mlstm",)],
                         ids=["xlstm", "mlstm_only"])
def test_xlstm_train_step_counts_the_same_on_cpu_and_meta(pattern):
    """One xLSTM smoke train step (remat on, 2 chunks a sequence): the
    kernels' launches and work equal on the CPU and on meta, two forward
    launches (the remat's recompute) and one backward launch per mLSTM
    layer, each at launches x least work.  With the mLSTM layers alone the
    whole count (FLOPs and bytes) is equal too; the sLSTM loop folds on
    meta, which counts its trips otherwise (test_torch_roofline.py)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    cfg = dataclasses.replace(get_smoke_config("xlstm-1.3b"), dtype="float32",
                              remat=True, pattern=pattern)
    B, S = 2, 64
    got = {d: _count_train_step(cfg, d, B, S) for d in ("cpu", "meta")}
    assert got["cpu"].kernels == got["meta"].kernels
    n_mlstm = cfg.pattern.count("mlstm") * cfg.n_rep
    BH, hd = B * cfg.n_heads, cfg.d_model * cfg.ssm_expand // cfg.n_heads
    for name, fn, launches in (("mlstm_chunk", work.mlstm_chunk, 2),
                               ("mlstm_chunk_bwd", work.mlstm_chunk_bwd, 1)):
        n_bytes, flops = fn(BH, S, hd, cfg.mlstm_chunk)
        k = launches * n_mlstm
        assert got["cpu"].kernels[name] == {"launches": k, "flops": k * flops,
                                            "bytes": k * n_bytes}
    if pattern == ("mlstm",):
        assert got["cpu"].flops == got["meta"].flops
        assert got["cpu"].hbm_bytes == got["meta"].hbm_bytes
