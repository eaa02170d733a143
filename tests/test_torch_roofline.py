"""The port's work count (``repro_torch.counting``,
``launch/roofline.py``) against the JAX package's HLO analyzer
(``launch/roofline.py:analyze_hlo``) on the same programs.

* Known-cost programs (the reference's ``tests/test_roofline_analyzer.py``):
  one matmul, a loop of 8 matmuls and a nested loop (the port's loops
  folded on the meta device and walked on the CPU), FLOPs within rtol 0.05
  of ``analyze_hlo``'s, as that file holds its own; an all-reduce and an
  all-gather on a fake group of 4 ranks, collective bytes equal to
  ``analyze_hlo`` of the same collectives in HLO text (the JAX package
  here has one device, which compiles collectives away).
* Eager traffic: an elementwise program's bytes are every op's operands
  and results, not XLA's fused count (not held to the reference's).
* A smoke ``Transformer`` prefill (the plain attention on both sides):
  FLOPs within 2% of ``analyze_hlo``'s.  The smoke train step with remat:
  within 5%; the measured gap is 0.05% (smollm-135m smoke, 2 x 32
  tokens), from the reference's label logit, a one-hot product of
  2 B S V FLOPs forward and again backward, where the port gathers.
* ``model_flops_for`` equal; the flash kernel's reported work equal on the
  CPU and meta routes and to the least-work formula; a folded loop
  (``time_scan`` on meta) counts exactly what the walked loop counts
  forward, and backward at most one trip's carry gradient more.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.models import Transformer as JTransformer  # noqa: E402
from repro.models import TrainState as JTrainState  # noqa: E402
from repro.models import make_train_step as jmake_train_step  # noqa: E402
from repro.models.config import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch import counting  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import ops, work  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.mesh import fake_world  # noqa: E402
from repro_torch.models import (INPUT_SHAPES, TrainState, Transformer,  # noqa: E402
                                make_train_step, tree_leaves)
from repro_torch.models import ssm  # noqa: E402
from repro_torch.optim import adam  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hlo(f, *shapes):
    structs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return jroof.analyze_hlo(jax.jit(f).lower(*structs).compile().as_text())


def _t(shape, device):
    return (torch.empty(shape, device="meta") if device == "meta"
            else torch.randn(shape))


DEVICES = ["cpu", "meta"]


@pytest.mark.parametrize("device", DEVICES)
def test_single_matmul(device):
    a, b = _t((64, 128), device), _t((128, 32), device)
    mine = roofline.count_ops(lambda: a @ b)
    ref = _hlo(lambda x, y: x @ y, (64, 128), (128, 32))
    np.testing.assert_allclose(mine.flops, ref.flops, rtol=0.05)
    assert mine.flops == 2 * 64 * 128 * 32
    assert mine.flops_by_dtype == {"float32": 2 * 64 * 128 * 32}


@pytest.mark.parametrize("device", DEVICES)
def test_loop_of_matmuls_multiplies_by_trip_count(device):
    x, w = _t((64, 64), device), _t((64, 64), device)
    mine = roofline.count_ops(lambda: counting.repeat(
        8, lambda c: torch.tanh(c @ w), x, like=x))

    def f(x, w):
        return jax.lax.scan(lambda c, _: (jnp.tanh(c @ w), None), x, None,
                            length=8)[0]
    ref = _hlo(f, (64, 64), (64, 64))
    np.testing.assert_allclose(mine.flops, ref.flops, rtol=0.05)
    assert mine.flops == 8 * 2 * 64 ** 3


@pytest.mark.parametrize("device", DEVICES)
def test_nested_loop(device):
    x, w = _t((32, 32), device), _t((32, 32), device)

    def inner(c):
        return torch.tanh(c @ w)

    def outer(c):
        return counting.repeat(3, inner, c, like=x)
    mine = roofline.count_ops(lambda: counting.repeat(4, outer, x, like=x))

    def f(x, w):
        def outer_j(c, _):
            return jax.lax.scan(lambda ci, _: (jnp.tanh(ci @ w), None), c,
                                None, length=3)[0], None
        return jax.lax.scan(outer_j, x, None, length=4)[0]
    ref = _hlo(f, (32, 32), (32, 32))
    np.testing.assert_allclose(mine.flops, ref.flops, rtol=0.05)
    assert mine.flops == 12 * 2 * 32 ** 3


_AR_HLO = """HloModule m
%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(f32[] %a, f32[] %b)
}
ENTRY %main (p: f32[64,128]) -> f32[64,128] {
  %p = f32[64,128]{1,0} parameter(0)
  ROOT %ar = f32[64,128]{1,0} all-reduce(f32[64,128]{1,0} %p), replica_groups={{0,1,2,3}}, to_apply=%add
}
"""
_AG_HLO = """HloModule m
ENTRY %main (p: f32[64,128]) -> f32[256,128] {
  %p = f32[64,128]{1,0} parameter(0)
  ROOT %ag = f32[256,128]{1,0} all-gather(f32[64,128]{1,0} %p), replica_groups={{0,1,2,3}}, dimensions={0}
}
"""


def test_collective_bytes_on_a_fake_group():
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol
    with fake_world(4):
        for device in DEVICES:
            x = _t((64, 128), device)
            mine = roofline.count_ops(lambda: dist.all_reduce(x))
            ref = jroof.analyze_hlo(_AR_HLO)
            assert mine.collectives == ref.collectives == {
                "all-reduce": 2 * 64 * 128 * 4}
            assert mine.collective_bytes == ref.collective_bytes
            mine = roofline.count_ops(
                lambda: funcol.wait_tensor(
                    funcol.all_gather_single(x, 0, dist.group.WORLD)))
            ref = jroof.analyze_hlo(_AG_HLO)
            assert mine.collectives == ref.collectives == {
                "all-gather": 256 * 128 * 4}
    assert not dist.is_initialized()


@pytest.mark.parametrize("device", DEVICES)
def test_elementwise_traffic_is_operands_plus_results(device):
    a = _t((1024, 1024), device)
    mine = roofline.count_ops(lambda: a * 2.0 + 1.0)
    nbytes = 1024 * 1024 * 4
    assert mine.hbm_bytes == 2 * (nbytes + nbytes)     # two unfused ops
    ref = _hlo(lambda x: x * 2.0 + 1.0, (1024, 1024))
    assert nbytes <= ref.hbm_bytes <= mine.hbm_bytes   # XLA fuses


B, S = 2, 32


def _batch(cfg, device):
    toks = (torch.empty((B, S), dtype=torch.int32, device="meta")
            if device == "meta" else torch.randint(0, cfg.vocab, (B, S),
                                                   dtype=torch.int32))
    return {"tokens": toks, "labels": toks}


def _jbatch():
    return {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
            for k in ("tokens", "labels")}


def test_smoke_prefill_flops_match_reference():
    arch = "smollm-135m"
    model = Transformer(get_smoke_config(arch))
    params = model.init(device="meta")
    batch = _batch(model.cfg, "meta")
    with torch.no_grad():
        mine = roofline.count_ops(lambda: model.forward(params, batch))
    jm = JTransformer(jget_smoke(arch))
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    text = jax.jit(lambda p, b: jm.forward(p, b)[0]).lower(
        jp, {"tokens": _jbatch()["tokens"]}).compile().as_text()
    ref = jroof.analyze_hlo(text)
    np.testing.assert_allclose(mine.flops, ref.flops, rtol=0.02)


def test_smoke_train_step_with_remat_flops_match_reference():
    arch = "smollm-135m"
    cfg = dataclasses.replace(get_smoke_config(arch), remat=True)
    model = Transformer(cfg)
    params = model.init(device="meta")
    opt = adam(1e-3, b1=0.9, b2=0.95, moment_dtype=torch.float32)
    state = TrainState(params, opt.init(tree_leaves(params)), 0)
    mine = roofline.count_ops(make_train_step(model, opt), state,
                              _batch(cfg, "meta"))
    jm = JTransformer(dataclasses.replace(jget_smoke(arch), remat=True))
    jo = jadam(1e-3, b1=0.9, b2=0.95, moment_dtype=jnp.float32)
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    js = JTrainState(jp, jax.eval_shape(jo.init, jp),
                     jax.ShapeDtypeStruct((), jnp.int32))
    text = jax.jit(jmake_train_step(jm, jo)).lower(
        js, _jbatch()).compile().as_text()
    ref = jroof.analyze_hlo(text)
    np.testing.assert_allclose(mine.flops, ref.flops, rtol=0.05)
    # the reference's one-hot label logit, forward and backward
    gap = ref.flops - mine.flops
    assert abs(gap - 4 * B * S * cfg.vocab) <= 1e-3 * ref.flops


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_for_matches_reference(arch):
    for name, shape in INPUT_SHAPES.items():
        assert (roofline.model_flops_for(get_config(arch), shape, shape.mode)
                == jroof.model_flops_for(jget_config(arch), JSHAPES[name],
                                         shape.mode))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 24)])
def test_flash_work_is_the_same_on_every_route(dtype, causal, window):
    dt = getattr(torch, dtype)
    Bq, H, Kh, Sq, hd = 2, 4, 2, 40, 32

    def step(q, k, v):
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        return torch.autograd.grad(out.float().sum(), (q, k, v))
    got = {}
    for d in DEVICES:
        qkv = [torch.randn((Bq, n, Sq, hd), dtype=dt).to(d).requires_grad_()
               for n in (H, Kh, Kh)]
        got[d] = roofline.count_ops(step, *qkv)
    assert got["cpu"].kernels == got["meta"].kernels
    assert got["cpu"].flops == got["meta"].flops
    assert got["cpu"].hbm_bytes == got["meta"].hbm_bytes
    # padded to 128 queries and keys; kv_len the unpadded 40
    mask = dict(causal=causal, window=window, kv_len=Sq)
    for kind in ("fwd", "dq", "dkv"):
        n_bytes, flops = work.flash_attention(kind, Bq * H, 128, hd, dt,
                                              **mask)
        assert got["cpu"].kernels[f"flash_attention_{kind}"] == {
            "launches": 1, "flops": flops, "bytes": n_bytes}


def _ssm_cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


@pytest.mark.parametrize("block", ["mamba", "slstm"])
@pytest.mark.parametrize("grad", [False, True], ids=["prefill", "train"])
def test_folded_loop_counts_what_the_walk_counts(block, grad):
    arch = "jamba-1.5-large-398b" if block == "mamba" else "xlstm-1.3b"
    cfg = _ssm_cfg(arch)
    init = ssm.init_mamba if block == "mamba" else ssm.init_slstm
    run = ssm.mamba_block if block == "mamba" else ssm.slstm_block
    g = torch.Generator().manual_seed(0)
    params = init(g, cfg, torch.float32)
    x = torch.randn((2, 16, cfg.d_model), generator=g)

    def fn(p, xd):
        with torch.set_grad_enabled(grad):
            y, state = run(p, xd, cfg, return_state=True)
            if grad:
                torch.autograd.grad(y.sum(), [xd, *p.values()])
            return y, state

    def on(device):
        return ({k: v.to(device).requires_grad_(grad)
                 for k, v in params.items()},
                x.to(device).requires_grad_(grad))
    folded = roofline.count_ops(fn, *on("meta"))
    walked = roofline.count_ops(fn, *on("cpu"))     # values: walked
    if grad:
        # a folded backward charges a middle trip's carry gradient to the
        # first trip too, whose carry has none in the walk
        assert walked.flops <= folded.flops <= walked.flops * (1 + 1 / 16)
    else:
        assert folded.flops == walked.flops > 0
        assert folded.hbm_bytes == walked.hbm_bytes
    y, state = fn(*on("meta"))
    assert tuple(y.shape) == (2, 16, cfg.d_model)
    assert type(state).__name__ in ("MambaState", "SLSTMState")


def test_folded_loop_gives_the_walks_values():
    cfg = _ssm_cfg("xlstm-1.3b")
    g = torch.Generator().manual_seed(0)
    p = ssm.init_slstm(g, cfg, torch.float32)
    x = torch.randn((2, 12, cfg.d_model), generator=g)
    want = ssm.slstm_block(p, x, cfg, return_state=True)
    with counting.OpCounter():           # CPU tensors: walked, not folded
        got = ssm.slstm_block(p, x, cfg, return_state=True)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def test_roofline_report_names_mfu():
    stats = roofline.HLOStats(flops_by_dtype={"bfloat16": 989e12,
                                              "float32": 67e12},
                              hbm_bytes=3.35e12, collective_bytes=450e9)
    stats.flops = 989e12 + 67e12
    rep = roofline.roofline_from_stats(stats, arch="a", shape="s", mesh="1",
                                       chips=1, model_flops=989e12 / 2)
    assert rep.compute_s == pytest.approx(2.0)
    assert rep.memory_s == pytest.approx(1.0)
    assert rep.collective_s == pytest.approx(1.0)
    d = rep.as_dict(seconds=1.0)
    assert d["mfu"] == pytest.approx(0.5) and d["dominant"] == "compute"
    assert "mfu" not in rep.as_dict()
