"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA card (the kernels are built by nvcc at first use and launch
only on the device); every test skips without one.  Imports no JAX, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Encode and decode run the plain versions' own float32 operations in the
same order with no fused multiply-add, so they must agree exactly.  The
activation kernel sums each span's exponentials in lane order, PyTorch in
its own reduction order: atol 2e-6 on values in [-1, 1], and the hard
one-hots must be equal.  Its backward sums each span's exponentials and
``ct * y`` as a ``__shfl_xor_sync`` tree over the threads of a group (each
thread first folding its lanes in order past 32 lanes), autograd in
PyTorch's order, so y differs by an ulp or two, as the forward's does: for
upstream gradients in [-1, 1], atol 3e-5, since
``y * (ct - sum(ct * y)) / tau`` multiplies the soft sample's 2e-6 by up
to |ct - dot| / tau = 10; padded lanes give exactly 0.  The decode is held
to its plain version exactly at every 4-byte offset of the slots' base
from a 16-byte boundary.  The merge kernel sums the same products in client order; the plain version's
normalizing sum of the weights may round an ulp apart: rtol 1e-6, atol
1e-7, and an all-zero edge gives exact +0.0.  The single-column encode equals its plain version
exactly, as the table encode does, each at every 4-byte offset of x and
of the Gumbels from a 16-byte boundary (the kernel stages and stores the
head and tail of every stretch apart), at the main path's shapes, ragged
tiles, Kmax 1 and Q x Kmax 3,072.

The flash-attention kernels sum their products in tile order (float32
inputs as fused multiply-adds on the CUDA cores, bfloat16 inputs on the
tensor cores with P and dS split into two bf16 operands), the plain
versions as PyTorch's matrix products do: for unit normal inputs, float32
outputs and lse within 2e-5 and gradients within 1e-4 of the largest
plain gradient.  A bfloat16 output is the float32 result rounded once in
each, so the two may sit one bfloat16 ulp apart where they straddle a
rounding boundary: rtol 2^-7.

The chunkwise mLSTM kernel sums its products as fused multiply-adds in
tile order and its cumulative gate sum in step order, the plain version
as PyTorch's matrix products and ``cumsum`` do: h, C and n rtol 1e-4,
atol 2e-4 (tighter than the reference's own kernel-vs-oracle 2e-3 /
2e-4), the stabilizer m atol 1e-5 (one float32 ulp of a cumulative gate
sum of ~30).  Through a whole model (the xLSTM smoke config, float32)
the card's logits agree with the CPU's at rtol 1e-4, atol 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_dkv_cuda, flash_dq_cuda, flash_fwd_cuda)
from repro_torch.kernels.mlstm_chunk import mlstm_chunk_cuda  # noqa: E402
from repro_torch.kernels.segment_activations import (  # noqa: E402
    BACKWARD_LAYOUTS, segment_activations_bwd_cuda, segment_activations_cuda)
from repro_torch.kernels.vgm_decode import vgm_decode_table_cuda  # noqa: E402
from repro_torch.kernels.vgm_encode import (  # noqa: E402
    vgm_encode_cuda, vgm_encode_table_cuda)
from repro_torch.kernels.weighted_agg import weighted_agg_cuda  # noqa: E402
from torch_kernel_inputs import (ACT_LAYOUTS, COLUMN_CASES,  # noqa: E402
                                 DECODE_CASES, ENCODE_CASES, FLASH_CASES,
                                 activation_inputs, as_tensors, decode_inputs,
                                 encode_inputs, mlstm_inputs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built by nvcc at "
                    "first use and launch only on the device")
    return torch.device("cuda", torch.cuda.current_device())


def _on(device, arrays):
    return [a.to(device) for a in as_tensors(*arrays)]


def _shifted(t, shift):
    """``t`` in a view ``shift`` floats past a 16-byte boundary."""
    if not shift:
        return t
    big = torch.zeros(t.numel() + 4, device=t.device)
    off = (4 - big.data_ptr() // 4 % 4 + shift) % 4
    view = big[off:off + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4 * shift
    return view


@pytest.mark.parametrize("N,Q,K,ks", ENCODE_CASES)
@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_vgm_encode_table_matches_plain(cuda, N, Q, K, ks, shift):
    """Exactly the plain version, with x and the Gumbels at aligned bases
    and in views 1-3 floats past one (x by ``shift``, the Gumbels by
    ``4 - shift``)."""
    x, means, stds, logw, g = _on(cuda, encode_inputs(1, N, Q, K, ks))
    inputs = (_shifted(x, shift), means, stds, logw,
              _shifted(g, (4 - shift) % 4))
    before = _build.DISPATCH_COUNTS["vgm_encode_table"]
    out = ops.vgm_encode_table(*inputs)
    torch.cuda.synchronize()
    assert _build.DISPATCH_COUNTS["vgm_encode_table"] == before + 1
    torch.testing.assert_close(out, tref.vgm_encode_table_ref(*inputs),
                               rtol=0, atol=0)


@pytest.mark.parametrize("N,Q,K,ks", DECODE_CASES)
@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_vgm_decode_table_matches_plain(cuda, N, Q, K, ks, shift):
    """Exactly the plain version, with the slots at an aligned base and in
    a view ``shift`` floats past it, not 16-byte aligned."""
    slots, means, stds = _on(cuda, decode_inputs(2, N, Q, K, ks))
    if shift:
        big = torch.zeros(slots.numel() + shift, device=cuda)
        big[shift:] = slots.reshape(-1)
        slots = big[shift:].view(slots.shape)
        assert slots.data_ptr() % 16 != 0
    before = _build.DISPATCH_COUNTS["vgm_decode_table"]
    out = ops.vgm_decode_table(slots, means, stds)
    torch.cuda.synchronize()
    assert _build.DISPATCH_COUNTS["vgm_decode_table"] == before + 1
    torch.testing.assert_close(out, tref.vgm_decode_table_ref(slots, means,
                                                              stds),
                               rtol=0, atol=0)


def _check_activations(cuda, layout, hard, forced="auto"):
    px, pu, lay = activation_inputs(3, 4099, ACT_LAYOUTS[layout], 0.2)
    args = _on(cuda, (px, pu, lay.kinds))
    out = segment_activations_cuda(*args, 0.2, hard, layout=forced)
    torch.cuda.synchronize()
    plain = tref.segment_activations_ref(*args, 0.2, hard)
    torch.testing.assert_close(out, plain, rtol=0, atol=2e-6)
    if hard:
        soft = ~lay.pack_pad & (np.repeat(lay.kinds[:, 0], lay.wmax) < 0.5)
        soft = torch.as_tensor(soft, device=cuda)
        assert torch.equal(out[:, soft].round(), plain[:, soft].round())


@pytest.mark.parametrize("layout", ["ctgan", "width1", "one_span", "w24",
                                    "w32", "mid", "wide"])
@pytest.mark.parametrize("hard", [False, True])
def test_segment_activations_matches_plain(cuda, layout, hard):
    _check_activations(cuda, layout, hard)


@pytest.mark.parametrize("layout", ["width1", "ctgan", "w32", "wide"])
@pytest.mark.parametrize("forced", ["tile", "warp", "warp_unstaged"])
def test_segment_activations_every_forward_layout_matches_plain(cuda, layout,
                                                                forced):
    """Each of the forward's layouts, whichever Wmax would route to it: the
    tile, the warp with its stage, and the warp that recomputes (taken for
    spans wider than a block's shared memory)."""
    _check_activations(cuda, layout, True, forced)


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


@pytest.mark.parametrize("layout", sorted(ACT_LAYOUTS))
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("rows", [500, 4099])
@pytest.mark.parametrize("forced", sorted(BACKWARD_LAYOUTS))
def test_segment_activations_bwd_matches_plain(cuda, layout, hard, rows,
                                               forced):
    """Every layout of the card tests, at the training batch and at 4,099
    rows, in each of the backward's layouts; padded lanes give 0."""
    px, pu, lay = activation_inputs(6, rows, ACT_LAYOUTS[layout], 0.2)
    x, u, kinds = _on(cuda, (px, pu, lay.kinds))
    ct = torch.rand(x.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(6)) * 2 - 1
    before = _build.DISPATCH_COUNTS["segment_activations_bwd"]
    grad = segment_activations_bwd_cuda(x, u, kinds, ct, 0.2, layout=forced)
    torch.cuda.synchronize()
    assert _build.DISPATCH_COUNTS["segment_activations_bwd"] == before + 1
    plain = tref.segment_activations_bwd_ref(x, u, kinds, ct, 0.2, hard)
    torch.testing.assert_close(grad, plain, rtol=0, atol=3e-5)
    assert not grad[:, torch.as_tensor(lay.pack_pad, device=cuda)].any()


def test_ops_segment_activations_backward_runs_the_kernel(cuda):
    """A forward that needs a gradient goes through the autograd function:
    one forward and one backward launch, and the plain route's gradient."""
    spans = ACT_LAYOUTS["ctgan"]
    g = torch.Generator(cuda).manual_seed(7)
    dim = spans[-1].start + spans[-1].width
    logits = torch.randn((500, dim), device=cuda, generator=g)
    u = torch.rand((500, dim), device=cuda, generator=g)
    ct = torch.rand((500, dim), device=cuda, generator=g) * 2 - 1
    x = logits.clone().requires_grad_()
    with ops.dispatch_scope() as d:
        torch.sum(ops.segment_activations(x, spans, u, 0.2, hard=True)
                  * ct).backward()
        torch.cuda.synchronize()
    assert dict(d) == {"segment_activations": 1,
                       "segment_activations_bwd": 1}
    xc = logits.cpu().requires_grad_()
    torch.sum(ops.segment_activations(xc, spans, u.cpu(), 0.2, hard=True)
              * ct.cpu()).backward()
    torch.testing.assert_close(x.grad.cpu(), xc.grad, rtol=0, atol=3e-5)


@pytest.mark.parametrize("E,C,D", [(1, 5, 1_238_401), (2, 2, 100_003),
                                   (3, 1, 7)])
def test_weighted_agg_matches_plain(cuda, E, C, D):
    g = torch.Generator(cuda).manual_seed(E * C)
    stacked = torch.randn((E, C, D), device=cuda, generator=g)
    w = torch.rand((E, C), device=cuda, generator=g)
    if E > 1:
        w[-1] = 0.0
    before = _build.DISPATCH_COUNTS["weighted_agg"]
    out = weighted_agg_cuda(stacked, w)
    torch.cuda.synchronize()
    assert _build.DISPATCH_COUNTS["weighted_agg"] == before + 1
    for e in range(E):
        torch.testing.assert_close(out[e], tref.weighted_agg_ref(stacked[e],
                                                                 w[e]),
                                   rtol=1e-6, atol=1e-7)
    if E > 1:                      # the all-zero edge: exact +0.0
        assert not out[-1].any() and not torch.signbit(out[-1]).any()
    flat = ops.weighted_average_flat(stacked[0], w[0])
    torch.testing.assert_close(flat, out[0], rtol=0, atol=0)


@pytest.mark.parametrize("N,K,k", COLUMN_CASES)
@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_vgm_encode_column_matches_plain(cuda, N, K, k, shift):
    x, means, stds, logw, g = _on(cuda, encode_inputs(8, N, 1, K, [k]))
    args = (_shifted(x[:, 0].contiguous(), shift), means[0], stds[0],
            logw[0], _shifted(g, (4 - shift) % 4))
    before = _build.DISPATCH_COUNTS["vgm_encode"]
    alpha, beta = ops.vgm_encode(*args)
    torch.cuda.synchronize()
    assert _build.DISPATCH_COUNTS["vgm_encode"] == before + 1
    pa, pb = tref.vgm_encode_ref(*args)
    torch.testing.assert_close(alpha, pa, rtol=0, atol=0)
    torch.testing.assert_close(beta, pb, rtol=0, atol=0)


def _flash_inputs(device, B, H, S, hd, dtype, seed):
    g = torch.Generator(device).manual_seed(seed)
    return [torch.randn((B, H, S, hd), device=device, generator=g).to(dtype)
            for _ in range(4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels_match_plain(cuda, case, dtype):
    B, H, S, hd, causal, window, kv_len = case
    q, k, v, do = _flash_inputs(cuda, B, H, S, hd, dtype, S + hd)
    mask = {"causal": causal, "window": window, "kv_len": kv_len}
    with ops.dispatch_scope() as d:
        out, lse = flash_fwd_cuda(q, k, v, **mask)
        delta = torch.sum(do.float() * out.float(), dim=-1)
        dq = flash_dq_cuda(q, k, v, do, lse, delta, **mask)
        dk, dv = flash_dkv_cuda(q, k, v, do, lse, delta, **mask)
        torch.cuda.synchronize()
    assert dict(d) == {"flash_attention_fwd": 1, "flash_attention_dq": 1,
                       "flash_attention_dkv": 1}
    p_out, p_lse = tref.flash_attention_fwd_ref(q, k, v, **mask)
    if dtype == torch.float32:
        torch.testing.assert_close(out, p_out, rtol=0, atol=2e-5)
    else:
        torch.testing.assert_close(out.float(), p_out.float(), rtol=2 ** -7,
                                   atol=1e-6)
    torch.testing.assert_close(lse, p_lse, rtol=0, atol=2e-5)
    p_dq = tref.flash_attention_dq_ref(q, k, v, do, lse, delta, **mask)
    p_dk, p_dv = tref.flash_attention_dkv_ref(q, k, v, do, lse, delta, **mask)
    for got, want in ((dq, p_dq), (dk, p_dk), (dv, p_dv)):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * max(1.0, float(want.abs().max())))


def test_flash_library_follows_dtype(cuda, monkeypatch):
    """A bfloat16 launch reaches the tensor-core library
    (``csrc/flash_attention_sm90.cu``), a float32 launch the CUDA-core one
    (``csrc/flash_attention.cu``), for each of the three entries."""
    seen = []
    real = _build.kernel_function

    def spy(stem, name, argtypes):
        seen.append((stem, name))
        return real(stem, name, argtypes)
    monkeypatch.setattr(_build, "kernel_function", spy)
    mask = {"causal": True, "window": None, "kv_len": 128}
    for dtype, stem in ((torch.bfloat16, "flash_attention_sm90"),
                        (torch.float32, "flash_attention")):
        seen.clear()
        q, k, v, do = _flash_inputs(cuda, 1, 2, 128, 64, dtype, 3)
        out, lse = flash_fwd_cuda(q, k, v, **mask)
        delta = torch.sum(do.float() * out.float(), dim=-1)
        flash_dq_cuda(q, k, v, do, lse, delta, **mask)
        flash_dkv_cuda(q, k, v, do, lse, delta, **mask)
        torch.cuda.synchronize()
        assert seen == [(stem, "flash_attention_fwd"),
                        (stem, "flash_attention_dq"),
                        (stem, "flash_attention_dkv")]


def test_flash_attention_autograd_runs_the_kernels(cuda):
    """ops.flash_attention on the card: GQA expansion and ragged padding
    around the autograd function, one launch of each kernel, and the CPU
    route's output and gradients."""
    g = torch.Generator(cuda).manual_seed(11)
    q = torch.randn((2, 4, 200, 64), device=cuda, generator=g)
    k, v = (torch.randn((2, 2, 200, 64), device=cuda, generator=g)
            for _ in range(2))
    ct = torch.randn((2, 4, 200, 64), device=cuda, generator=g)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    with ops.dispatch_scope() as d:
        out = ops.flash_attention(*leaves, causal=True)
        torch.sum(out * ct).backward()
        torch.cuda.synchronize()
    assert dict(d) == {"flash_attention_fwd": 1, "flash_attention_dq": 1,
                       "flash_attention_dkv": 1}
    cpu = [t.cpu().requires_grad_() for t in (q, k, v)]
    out_c = ops.flash_attention(*cpu, causal=True)
    torch.sum(out_c * ct.cpu()).backward()
    torch.testing.assert_close(out.cpu(), out_c.detach(), rtol=0, atol=2e-5)
    for a, b in zip(leaves, cpu):
        torch.testing.assert_close(a.grad.cpu(), b.grad, rtol=0,
                                   atol=1e-4 * max(1.0, float(b.grad.abs().max())))


def test_flash_wrappers_check_inputs(cuda):
    q, k, v, _ = _flash_inputs(cuda, 1, 2, 64, 64, torch.float32, 1)
    mask = {"causal": True, "window": None, "kv_len": 64}
    with pytest.raises(ValueError, match="head dim"):
        flash_fwd_cuda(q[..., :48].contiguous(), k[..., :48].contiguous(),
                       v[..., :48].contiguous(), **mask)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_fwd_cuda(q, k.bfloat16(), v, **mask)
    with pytest.raises(RuntimeError, match="requires grad"):
        flash_fwd_cuda(q.requires_grad_(), k, v, **mask)
    # the bf16 kernels' tensor maps need 16-byte aligned starts
    kb, vb = k.bfloat16(), v.bfloat16()
    shifted = torch.zeros(kb.numel() + 1, dtype=torch.bfloat16,
                          device=cuda)[1:].view(kb.shape)
    with pytest.raises(ValueError, match="16-byte"):
        flash_fwd_cuda(shifted, kb, vb, **mask)


MLSTM_CASES = [  # BH, S, hd, chunk, constant log_f
    (2, 64, 32, 16, None), (4, 128, 64, 32, None), (1, 256, 128, 128, None),
    (3, 96, 16, 32, None),        # the reference's kernel-test shapes
    (1, 32, 16, 16, -30.0),       # strong decay: the state resets every step
    (16, 512, 128, 32, None),     # the xlstm-1.3b smoke config's head dim
    (5, 256, 64, 256, None),      # one chunk, S == L
    (3, 36, 48, 12, None),        # L and hd not powers of two, BH odd
    (16, 2048, 1024, 256, None),  # the full-width prefill's shape
    # the tensor-core kernel's tile edges: chunks padded to 64-row tiles,
    # head dims padded to 64 columns or taking 64-column value tiles
    (1, 300, 32, 100, None),      # L not a multiple of 64, BH = 1
    (3, 260, 80, 130, None),      # hd 80 in a 128-column tile
    (2, 384, 192, 192, None),     # hd 192: 64-column value tiles
    (1, 768, 256, 256, None),     # BH = 1, two value tiles, three chunks
    (2, 512, 64, 256, -30.0),     # strong decay at whole tiles
]


@pytest.mark.parametrize("case", MLSTM_CASES)
def test_mlstm_chunk_matches_plain(cuda, case):
    BH, S, hd, chunk, log_f = case
    args = _on(cuda, mlstm_inputs(BH + S + hd, BH, S, hd, log_f=log_f))
    with ops.dispatch_scope() as d:
        h, (C, n, m) = ops.mlstm_chunk(*args, chunk=chunk, return_state=True)
        h_only = ops.mlstm_chunk(*args, chunk=chunk)
        torch.cuda.synchronize()
    assert dict(d) == {"mlstm_chunk": 2}
    p_h, (p_C, p_n, p_m) = tref.mlstm_chunk_plain(*args, chunk=chunk,
                                                  return_state=True)
    for got, want in ((h, p_h), (h_only, p_h), (C, p_C), (n, p_n)):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-4)
    torch.testing.assert_close(m, p_m, rtol=0, atol=1e-5)


def test_mlstm_chunk_refuses_grad(cuda):
    q, k, v, lf, li = _on(cuda, mlstm_inputs(1, 2, 32, 16))
    with pytest.raises(RuntimeError, match="requires grad"):
        mlstm_chunk_cuda(q.requires_grad_(), k, v, lf, li, chunk=16)
    with pytest.raises(NotImplementedError, match="xLSTM training"):
        ops.mlstm_chunk(q, k, v, lf, li, chunk=16)
    with torch.no_grad():
        assert ops.mlstm_chunk(q.detach(), k, v, lf, li,
                               chunk=16).shape == (2, 32, 16)


def test_mlstm_chunk_wrapper_checks_shapes(cuda):
    q, k, v, lf, li = _on(cuda, mlstm_inputs(2, 2, 512, 16))
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        mlstm_chunk_cuda(q, k, v, lf, li, chunk=48)
    with pytest.raises(ValueError, match="outside"):
        mlstm_chunk_cuda(q, k, v, lf, li, chunk=512)
    with pytest.raises(ValueError, match="multiple of 16"):
        mlstm_chunk_cuda(q[..., :8].contiguous(), k[..., :8].contiguous(),
                         v[..., :8].contiguous(), lf, li, chunk=16)
    with pytest.raises(ValueError, match="log_f has shape"):
        mlstm_chunk_cuda(q, k, v, lf[:, :-1].contiguous(), li, chunk=16)
    with pytest.raises(TypeError, match="float32"):
        mlstm_chunk_cuda(q, k.double(), v, lf, li, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        mlstm_chunk_cuda(q, k, v.transpose(1, 2).contiguous().transpose(1, 2),
                         lf, li, chunk=16)


def test_xlstm_prefill_on_the_card_matches_the_cpu(cuda):
    """The xlstm-1.3b smoke model (float32) prefilled on the card, through
    one kernel launch per mLSTM layer, against the same prefill on the
    CPU; then one decode step from each side's caches."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Transformer, tree_leaves, tree_unflatten
    cfg = dataclasses.replace(get_smoke_config("xlstm-1.3b"), dtype="float32",
                              n_layers=4)
    model = Transformer(cfg)
    params = model.init(seed=3, device="cpu")
    params_c = tree_unflatten(params, [t.detach().to(cuda)
                                       for t in tree_leaves(params)])
    tk = torch.randint(0, cfg.vocab, (2, 128),
                       generator=torch.Generator().manual_seed(3))
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        with ops.dispatch_scope() as d:
            logits, caches = model.prefill(params_c, {"tokens": tk.to(cuda)},
                                           160)
            torch.cuda.synchronize()
        logits_cpu, caches_cpu = model.prefill(params, {"tokens": tk}, 160)
        tok = torch.argmax(logits_cpu, -1)[:, None]
        n_card, _ = model.decode_step(params_c, caches, {"token": tok.to(cuda)})
        n_cpu, _ = model.decode_step(params, caches_cpu, {"token": tok})
    assert dict(d) == {"mlstm_chunk": 2}
    torch.testing.assert_close(logits.cpu(), logits_cpu, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(n_card.cpu(), n_cpu, rtol=1e-4, atol=1e-4)
