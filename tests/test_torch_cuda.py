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
1e-7, and an all-zero edge gives exact +0.0, as does the degraded
round's all-masked merge (rows zeroed, weights 0).  One MD-TGAN step on
the card is held to the same step on the CPU as a train step is: losses
rtol 1e-4, Adam moments atol 2e-6, parameters atol lr and 99% of them
within 2e-6.  The single-column encode equals its plain version
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
rounding boundary: rtol 2^-7.  At head dim 80 the same gates hold for
both libraries (bf16 in five 16-column panels, 32-byte swizzle);
through ``ops.flash_attention`` with bf16 inputs against the float32 CPU
route, outputs rtol 2^-7, atol 2^-8 and gradients (rounded to bf16 once)
2^-7 of the largest.  ``moe_ffn`` on the card: two runs bit-identical
(each scatter slot receives at most one nonzero row); in float32 the
CPU's output within rtol = atol = 1e-5, the routing equal.

The chunkwise mLSTM kernel sums its products as fused multiply-adds in
tile order and its cumulative gate sum in step order, the plain version
as PyTorch's matrix products and ``cumsum`` do: h, C and n rtol 1e-4,
atol 2e-4 (tighter than the reference's own kernel-vs-oracle 2e-3 /
2e-4), the stabilizer m atol 1e-5 (one float32 ulp of a cumulative gate
sum of ~30).  Through a whole model (the xLSTM smoke config, float32)
the card's logits agree with the CPU's at rtol 1e-4, atol 1e-4.  The
mLSTM backward kernel sums its products on the tensor cores in tile
order, each float32 operand split into two bf16 terms (three in the raw
scores q k^T; tests/test_torch_mlstm_bwd_tc.py emulates it), the plain
backward as PyTorch's products: each gradient within 1e-4 of the largest
|entry| of the plain gradient (dlog_f of dlog_i's, whose terms it sums),
two calls bit-identical; one xLSTM smoke train step
(float32, remat) on the card against the CPU: loss rtol 1e-4, each
gradient within 1e-4 of its leaf's largest CPU entry.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_dkv_cuda, flash_dq_cuda, flash_fwd_cuda)
from repro_torch.kernels.mlstm_chunk import (  # noqa: E402
    mlstm_chunk_bwd_cuda, mlstm_chunk_cuda)
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


@pytest.mark.parametrize("ok", [(1, 0, 1, 1, 0), (0, 0, 0, 0, 0)])
def test_weighted_agg_masked_weights_match_plain(cuda, ok):
    """The degraded round's merge input: masked clients' rows zeroed and
    their weights 0 (``w * ok``); all masked gives exact +0.0, which the
    round then replaces with the previous model."""
    g = torch.Generator(cuda).manual_seed(11)
    stacked = torch.randn((5, 1_238_401), device=cuda, generator=g)
    ok = torch.tensor(ok, dtype=torch.bool, device=cuda)
    stacked[~ok] = float("nan")
    safe = torch.where(ok[:, None], stacked, 0.0)
    w = torch.rand(5, device=cuda, generator=g) * ok
    out = ops.weighted_average_flat(safe, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, tref.weighted_agg_ref(safe, w),
                               rtol=1e-6, atol=1e-7)
    if not ok.any():
        assert not out.any() and not torch.signbit(out).any()
    else:
        assert bool(torch.isfinite(out).all())


def test_md_step_on_the_card_matches_the_cpu(cuda):
    """One MD-TGAN step (3 critics, the central generator) on the card
    against the same step on the CPU, from the same weights and noise,
    TF32 off: losses rtol 1e-4, moments atol 2e-6, parameters atol lr and
    99% of elements within 2e-6 (Adam turns rounding-level gradients into
    lr-sized steps); 2P activation forwards and P backwards launched."""
    import copy

    from repro_torch.core.architectures import make_md_step
    from repro_torch.gan.ctgan import CTGANConfig
    from repro_torch.gan.trainer import (GANState, StepNoise,
                                         draw_step_noise, init_gan_state)
    from repro_torch.optim import AdamState
    from repro_torch.synth import DeviceSampler, SamplerDraws
    from repro_torch.tabular import fit_centralized_encoders, make_dataset

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu, P = torch.device("cpu"), 3
    cfg = CTGANConfig(z_dim=16, gen_hidden=(32, 32), disc_hidden=(32, 32),
                      pac=4, batch_size=64)
    ds = make_dataset("adult", n_rows=1200, seed=3)
    enc = fit_centralized_encoders(ds.data, ds.schema, device=cpu,
                                   generator=torch.Generator().manual_seed(3))
    encoded = enc.encode(ds.data,
                         generator=torch.Generator().manual_seed(4)).numpy()
    parts = np.array_split(encoded, P)
    tables = {d: [DeviceSampler(x, enc, d).tables for x in parts]
              for d in (cpu, cuda)}
    states = [init_gan_state(cfg, enc.cond_dim, enc.encoded_dim, device=cpu,
                             generator=torch.Generator().manual_seed(5 + p),
                             rng=torch.Generator().manual_seed(p))
              for p in range(P)]

    def to(x, d):
        return [t.to(d) for t in x] if isinstance(x, list) else x.to(d)

    def on_card(st):
        return GANState(copy.deepcopy(st.gen).to(cuda),
                        copy.deepcopy(st.disc).to(cuda),
                        AdamState(to(st.g_opt.mu, cuda), to(st.g_opt.nu, cuda),
                                  st.g_opt.count),
                        AdamState(to(st.d_opt.mu, cuda), to(st.d_opt.nu, cuda),
                                  st.d_opt.count), st.step,
                        torch.Generator(cuda))
    gpu_states = [on_card(st) for st in states]
    g = torch.Generator().manual_seed(9)
    B, n_spans = cfg.batch_size, tables[cpu][0].cum.shape[0]
    draws = [SamplerDraws(torch.randint(0, n_spans, (B,), generator=g),
                          torch.rand(B, generator=g), torch.rand(B, generator=g))
             for _ in range(P)]
    noise = [draw_step_noise(g, cfg, states[p].disc, B, enc.encoded_dim, cpu)
             for p in range(P)]
    step = make_md_step(cfg, enc.spans(), enc.condition_spans(), B)
    g_opt_cpu, m_cpu = step(states[0].gen, states[0].g_opt, states,
                            tables[cpu], draws=draws, noise=noise)
    with ops.dispatch_scope() as d:
        g_opt_gpu, m_gpu = step(
            gpu_states[0].gen, gpu_states[0].g_opt, gpu_states, tables[cuda],
            draws=draws, noise=[StepNoise(*(to(x, cuda) for x in nz))
                                for nz in noise])
        torch.cuda.synchronize()
    assert dict(d) == {"segment_activations": 2 * P,
                       "segment_activations_bwd": P}
    for k in ("g_loss", "d_loss"):
        torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k], rtol=1e-4,
                                   atol=1e-6)
    pairs = [(g_opt_gpu, g_opt_cpu)] + [(a.d_opt, b.d_opt) for a, b in
                                        zip(gpu_states, states)]
    for x, y in pairs:
        assert x.count == y.count
        for a, b in zip(x.mu + x.nu, y.mu + y.nu):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=2e-6)
    params = list(zip(gpu_states[0].gen.parameters(),
                      states[0].gen.parameters()))
    for a, b in zip(gpu_states, states):
        params += list(zip(a.disc.parameters(), b.disc.parameters()))
    diffs = torch.cat([(a.detach().cpu() - b.detach()).abs().reshape(-1)
                       for a, b in params])
    assert float(diffs.max()) <= cfg.lr
    assert float((diffs <= 2e-6).float().mean()) >= 0.99


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


# head dim 80 (hubert-xlarge: 1280 / 16), bidirectional: each library's
# hd-80 instance
FLASH80_CASES = [
    (1, 2, 1000, 80, False, None, 1000),  # ragged: a tile crosses S
    (2, 3, 384, 80, False, None, 300),    # padded keys past kv_len
    (4, 16, 2048, 80, False, None, 2048),  # hubert's training shape
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH80_CASES)
def test_flash_kernels_at_head_dim_80_match_plain(cuda, case, dtype):
    test_flash_kernels_match_plain(cuda, case, dtype)


def test_flash_attention_autograd_at_head_dim_80(cuda):
    """ops.flash_attention at hd 80, bidirectional, bf16 and float32: one
    launch of each kernel, outputs and gradients against the CPU
    route's."""
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(cuda).manual_seed(12)
        q, k, v, ct = (torch.randn((2, 4, 200, 80), device=cuda,
                                   generator=g).to(dtype) for _ in range(4))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        with ops.dispatch_scope() as d:
            out = ops.flash_attention(*leaves, causal=False)
            torch.sum((out * ct).float()).backward()
            torch.cuda.synchronize()
        assert dict(d) == {"flash_attention_fwd": 1, "flash_attention_dq": 1,
                           "flash_attention_dkv": 1}
        assert out.shape == (2, 4, 200, 80) and out.dtype == dtype
        cpu = [t.cpu().float().requires_grad_() for t in (q, k, v)]
        out_c = ops.flash_attention(*cpu, causal=False)
        torch.sum(out_c * ct.cpu().float()).backward()
        if dtype == torch.float32:
            torch.testing.assert_close(out.cpu(), out_c.detach(), rtol=0,
                                       atol=2e-5)
        else:     # bf16 inputs, float32 plain: out and grads rounded once
            torch.testing.assert_close(out.cpu().float(), out_c.detach(),
                                       rtol=2 ** -7, atol=2 ** -8)
        for a, b in zip(leaves, cpu):
            assert a.grad.shape == b.grad.shape
            scale = max(1.0, float(b.grad.abs().max()))
            tol = 1e-4 if dtype == torch.float32 else 2 ** -7
            torch.testing.assert_close(a.grad.cpu().float(), b.grad, rtol=0,
                                       atol=tol * scale)


def test_moe_ffn_scatter_is_deterministic_on_the_card(cuda):
    """Dropped choices are zeroed before the scatter, so every buffer slot
    gets at most one nonzero row: two card runs of ``moe_ffn`` (bf16,
    drops active) are bit-identical; in float32 the card's output is the
    CPU's within 1e-5, with the same routing."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe
    base = dataclasses.replace(get_smoke_config("mixtral-8x22b"),
                               capacity_factor=0.5)
    for dtype in (torch.bfloat16, torch.float32):
        p = moe.init_moe(torch.Generator(cuda).manual_seed(1), base, dtype)
        x = torch.randn((4, 256, 256), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(2)).to(
                            dtype)
        out1, m1 = moe.moe_ffn(p, x, base)
        out2, m2 = moe.moe_ffn(p, x, base)
        torch.cuda.synchronize()
        assert 0.0 < float(m1.dropped_fraction) < 1.0
        assert torch.equal(out1, out2) and torch.equal(m1.aux_loss,
                                                       m2.aux_loss)
        if dtype == torch.float32:
            pc = {"router": p["router"].cpu(),
                  "experts": {k: t.cpu() for k, t in p["experts"].items()}}
            out_c, m_c = moe.moe_ffn(pc, x.cpu(), base)
            r, r_c = moe.moe_route(p, x, base), moe.moe_route(pc, x.cpu(),
                                                               base)
            assert torch.equal(r.expert_idx.cpu(), r_c.expert_idx)
            assert torch.equal(r.keep.cpu(), r_c.keep)
            torch.testing.assert_close(out1.cpu(), out_c, rtol=1e-5,
                                       atol=1e-5)
            assert float(m1.dropped_fraction) == float(m_c.dropped_fraction)


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


MLSTM_BWD_CASES = MLSTM_CASES + [
    (16, 512, 1024, 256, None),   # the full-width training step's shape
    # the tensor-core backward's tile edges: chunks padded to 128-row
    # planes, the state walks taking heads in groups
    (2, 8, 32, 1, None),          # L 1: one live row of a 128-row plane
    (2, 192, 64, 64, None),       # L 64: one 64-row tile, its pair empty
    (9, 512, 1024, 256, None),    # walks take heads in pairs, the last alone
]


def _mlstm_bwd_inputs(device, case):
    BH, S, hd, chunk, log_f = case
    args = _on(device, mlstm_inputs(BH + S + hd, BH, S, hd, log_f=log_f))
    dh = torch.from_numpy(np.random.default_rng(BH * S).normal(
        size=(BH, S, hd)).astype(np.float32)).to(device)
    return args, dh, chunk


def _close_to_largest(got, want, frac):
    """Each gradient within ``frac`` of the plain gradient's largest
    |entry|: each entry is a cancelling sum of many terms, which rounds at
    the scale of its largest terms, not of the result.  dlog_f sums the
    same terms as dlog_i (each gated score's gradient enters both), so
    its scale is the larger of the two: under strong decay its own
    largest entry is ~1e-12 while its terms are O(1)."""
    scales = [float(w.abs().max()) for w in want]
    scales[3] = max(scales[3], scales[4])
    for g, w, name, scale in zip(got, want, ("dq", "dk", "dv", "dlog_f",
                                             "dlog_i"), scales):
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        err = float((g - w).abs().max())
        assert err <= frac * max(scale, 1e-30), (name, err, scale)


@pytest.mark.parametrize("case", MLSTM_BWD_CASES)
def test_mlstm_chunk_bwd_matches_plain(cuda, case):
    """The backward kernel against ``mlstm_chunk_bwd_plain`` on the same
    inputs, each computing its own states: every gradient within 1e-4 of
    the largest plain gradient.  Both sum in other orders (the kernel as
    split-bf16 products on the tensor cores in tile order, the plain
    version as PyTorch's products); dlog_f is a reverse cumulative sum
    within each chunk, so its rounding grows with the chunk, not with
    S."""
    args, dh, chunk = _mlstm_bwd_inputs(cuda, case)
    with ops.dispatch_scope() as d:
        got = mlstm_chunk_bwd_cuda(*args, dh, chunk=chunk)
        torch.cuda.synchronize()
    assert dict(d) == {"mlstm_chunk_bwd": 1}
    want = tref.mlstm_chunk_bwd_plain(*args, dh, chunk=chunk)
    _close_to_largest(got, want, 1e-4)


def test_mlstm_chunk_bwd_is_bit_reproducible(cuda):
    """Two calls at the training shape give the same bits: every sum is a
    fixed tree or order, no atomics."""
    args, dh, chunk = _mlstm_bwd_inputs(cuda, MLSTM_BWD_CASES[-1])
    one = mlstm_chunk_bwd_cuda(*args, dh, chunk=chunk)
    two = mlstm_chunk_bwd_cuda(*args, dh, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_mlstm_chunk_under_autograd_launches_both_kernels(cuda):
    """``ops.mlstm_chunk`` under autograd: one forward launch, one backward
    launch, no plain version; the gradient is the backward kernel's; a
    gradient that reaches the final state raises."""
    args, dh, chunk = _mlstm_bwd_inputs(cuda, (4, 128, 64, 32, None))
    leaves = [t.requires_grad_() for t in args]
    with ops.dispatch_scope() as d:
        h = ops.mlstm_chunk(*leaves, chunk=chunk)
        grads = torch.autograd.grad(h, leaves, dh)
        torch.cuda.synchronize()
    assert dict(d) == {"mlstm_chunk": 1, "mlstm_chunk_bwd": 1}
    plain = mlstm_chunk_bwd_cuda(*(t.detach() for t in args), dh, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(grads, plain))
    h, (C, n, m) = ops.mlstm_chunk(*leaves, chunk=chunk, return_state=True)
    with pytest.raises(NotImplementedError, match="final state"):
        torch.autograd.grad(C.sum(), leaves[0])
    with pytest.raises(RuntimeError, match="requires grad"):
        mlstm_chunk_cuda(*leaves, chunk=chunk)
    with pytest.raises(ValueError, match="dh has shape"):
        mlstm_chunk_bwd_cuda(*(t.detach() for t in args),
                             dh[:, :-1].contiguous(), chunk=chunk)


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


def test_xlstm_train_step_on_the_card_matches_the_cpu(cuda):
    """The xlstm-1.3b smoke model (float32, remat on, 2 chunks of 32) takes
    one train step on the card and on the CPU from the same parameters and
    batch, TF32 off: losses rtol 1e-4, every gradient within 1e-4 of its
    leaf's largest CPU gradient (the kernels sum in other orders than
    PyTorch's CPU products; the gradient of a leaf is a cancelling sum);
    per mLSTM layer two forward launches (the forward and the remat's
    recompute) and one backward launch, no plain version."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Transformer, tree_leaves, tree_unflatten
    cfg = dataclasses.replace(get_smoke_config("xlstm-1.3b"), dtype="float32",
                              remat=True)
    model = Transformer(cfg)
    params = model.init(seed=5, device="cpu")
    params_c = tree_unflatten(params, [t.detach().to(cuda).requires_grad_()
                                       for t in tree_leaves(params)])
    tk = torch.randint(0, cfg.vocab, (2, 64),
                       generator=torch.Generator().manual_seed(5))
    torch.backends.cuda.matmul.allow_tf32 = False
    with ops.dispatch_scope() as d:
        loss_c, _ = model.loss(params_c, {"tokens": tk.to(cuda),
                                          "labels": tk.to(cuda)})
        grads_c = torch.autograd.grad(loss_c, tree_leaves(params_c))
        torch.cuda.synchronize()
    n_mlstm = cfg.pattern.count("mlstm") * cfg.n_rep
    assert dict(d) == {"mlstm_chunk": 2 * n_mlstm,
                       "mlstm_chunk_bwd": n_mlstm}
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    loss, _ = model.loss(params, {"tokens": tk, "labels": tk})
    grads = torch.autograd.grad(loss, leaves)
    torch.testing.assert_close(loss_c.cpu(), loss, rtol=1e-4, atol=0)
    for g_c, g in zip(grads_c, grads):
        assert float((g_c.cpu() - g).abs().max()) <= 1e-4 * max(
            float(g.abs().max()), 1e-30)


def _dp_setup(device, n_rows=1200):
    """A small adult table's encoders, sampler tables and one state, all
    on the CPU and on ``device``."""
    import copy

    from repro_torch.gan.ctgan import CTGANConfig
    from repro_torch.gan.trainer import GANState, init_gan_state
    from repro_torch.optim import AdamState
    from repro_torch.synth import DeviceSampler
    from repro_torch.tabular import fit_centralized_encoders, make_dataset

    cpu = torch.device("cpu")
    cfg = CTGANConfig(z_dim=16, gen_hidden=(32, 32), disc_hidden=(32, 32),
                      pac=4, batch_size=64)
    ds = make_dataset("adult", n_rows=n_rows, seed=3)
    enc = fit_centralized_encoders(ds.data, ds.schema, device=cpu,
                                   generator=torch.Generator().manual_seed(3))
    encoded = enc.encode(ds.data,
                         generator=torch.Generator().manual_seed(4)).numpy()
    tables = {d: DeviceSampler(encoded, enc, d).tables for d in (cpu, device)}
    st = init_gan_state(cfg, enc.cond_dim, enc.encoded_dim, device=cpu,
                        generator=torch.Generator().manual_seed(5),
                        rng=torch.Generator().manual_seed(6))

    def to(x):
        return [t.to(device) for t in x]
    card = GANState(copy.deepcopy(st.gen).to(device),
                    copy.deepcopy(st.disc).to(device),
                    AdamState(to(st.g_opt.mu), to(st.g_opt.nu), 0),
                    AdamState(to(st.d_opt.mu), to(st.d_opt.nu), 0), 0,
                    torch.Generator(device))
    return cfg, ds, enc, tables, st, card


def test_dp_step_on_the_card_matches_the_cpu(cuda):
    """One DP step (16 packs of 4) on the card against the same step on
    the CPU, from the same weights, batch and injected draws, TF32 off:
    the tolerance of a train step (losses rtol 1e-4, moments atol 2e-6,
    parameters atol lr and 99% of them within 2e-6; the per-pack sums are
    float32 in another order and Adam turns rounding-level gradients into
    lr-sized steps); one activation forward for the shared fake and one
    forward and backward for the generator step."""
    from repro_torch.gan.dp import draw_dp_step_noise, make_dp_train_steps
    from repro_torch.synth import draw_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, _, enc, tables, st, card = _dp_setup(cuda)
    cpu = torch.device("cpu")
    batch = draw_batch(tables[cpu], cfg.batch_size, enc.cond_dim,
                       generator=torch.Generator().manual_seed(7))
    noise = draw_dp_step_noise(torch.Generator().manual_seed(8), cfg,
                               st.disc, cfg.batch_size, enc.encoded_dim, cpu)
    step = make_dp_train_steps(cfg, enc.spans(), enc.condition_spans(),
                               l2_clip=1.0, noise_mult=0.3)
    m_cpu = step(st, batch, noise)
    with ops.dispatch_scope() as d:
        m_gpu = step(card, tuple(t.to(cuda) for t in batch),
                     type(noise)(*(
                         [t.to(cuda) for t in x] if isinstance(x, list)
                         else x.to(cuda) for x in noise)))
        torch.cuda.synchronize()
    assert dict(d) == {"segment_activations": 2,
                       "segment_activations_bwd": 1}
    for k in m_cpu:
        torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k], rtol=1e-4,
                                   atol=1e-6)
    for x, y in ((card.g_opt, st.g_opt), (card.d_opt, st.d_opt)):
        assert x.count == y.count == 1
        for a, b in zip(x.mu + x.nu, y.mu + y.nu):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=2e-6)
    diffs = torch.cat([(a.detach().cpu() - b.detach()).abs().reshape(-1)
                       for a, b in zip(card.params(), st.params())])
    assert float(diffs.max()) <= cfg.lr
    assert float((diffs <= 2e-6).float().mean()) >= 0.99


def test_traced_round_on_the_card_is_bit_identical(cuda):
    """A traced run and an untraced one at the same seed on the card:
    the same generator bit for bit, one merge launch a round; the round-1
    broadcast rebuilt from the trace (the reference's layout, merged on
    the host in float64) is the card's merged model within rtol 1e-6,
    atol 1e-7."""
    from repro_torch.core.architectures import run_federated
    from repro_torch.gan.ctgan import CTGANConfig
    from repro_torch.privacy import RoundTrace, global_params
    from repro_torch.tabular import make_dataset, partition_iid

    cfg = CTGANConfig(z_dim=16, gen_hidden=(32, 32), disc_hidden=(32, 32),
                      pac=4, batch_size=64)
    ds = make_dataset("adult", n_rows=1200, seed=4)
    parts = partition_iid(ds, 3, seed=4)
    kw = dict(cfg=cfg, rounds=2, local_steps=2, seed=2, device=cuda)
    tr, merged = RoundTrace(), []
    with ops.dispatch_scope() as d:
        traced = run_federated(
            parts, ds.schema, trace=tr, on_round=lambda r, st, m: merged.append(
                [t.detach().clone() for t in st[0].params()]), **kw)
        torch.cuda.synchronize()
    plain = run_federated(parts, ds.schema, **kw)
    assert d["weighted_agg"] == 2 and not any(k.endswith("_ref") for k in d)
    for a, b in zip(traced.final_g_params.parameters(),
                    plain.final_g_params.parameters()):
        assert torch.equal(a, b)
    assert tr.n_rounds == 2 and tr.updates[0].shape[0] == 3
    assert all(np.isfinite(u).all() for u in tr.updates)
    g = global_params(tr, cfg, traced.encoders, index=1)
    for a, b in zip(list(g["g"].parameters()) + list(g["d"].parameters()),
                    merged[0], strict=True):
        torch.testing.assert_close(a.detach(), b, rtol=1e-6, atol=1e-7)


_FIRST_TRAINING = """
import sys
from repro_torch.core.architectures import run_federated
from repro_torch.gan.ctgan import CTGANConfig
from repro_torch.gan.dp import DPConfig
from repro_torch.tabular import make_dataset, partition_iid
cfg = CTGANConfig(z_dim=16, gen_hidden=(32, 32), disc_hidden=(32, 32),
                  pac=4, batch_size=64)
ds = make_dataset("adult", n_rows=1200, seed=4)
parts = partition_iid(ds, 3, seed=4)
kw = {"dp": DPConfig(l2_clip=1.0, noise_mult=0.3)} if sys.argv[1] == "dp" else {}
runs = [[p.detach().clone() for p in run_federated(
    parts, ds.schema, cfg=cfg, rounds=2, local_steps=2, seed=2,
    device="cuda", **kw).final_g_params.parameters()] for _ in range(3)]
print(max(float((a - b).abs().max()) for r in runs[1:]
          for a, b in zip(runs[0], r)))
"""


@pytest.mark.parametrize("mode", ["fed", "dp"])
def test_first_training_of_a_process_is_bit_identical_to_later_ones(
        cuda, mode):
    """In a fresh process, the first federated CTGAN run (DP or not) ends
    with the same generator bit for bit as two later runs at the same
    seed.  The critic's gradient sums the WGAN term's and the penalty's
    apart (``gan/trainer.py:critic_grads``); summed by one autograd call,
    the order of the contributions followed the autograd engine's node
    order on the card, which differed in a process's first training."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run(
        [sys.executable, "-c", _FIRST_TRAINING, mode], capture_output=True,
        text=True, timeout=600, env=dict(os.environ, PYTHONPATH=str(src)))
    assert out.returncode == 0, out.stderr[-3000:]
    assert float(out.stdout.split()[-1]) == 0.0, out.stdout


def test_discriminator_scores_on_the_card_match_the_cpu(cuda):
    """The attack's scores of one critic on the card (the encode on
    ``vgm_encode_table``) against the CPU, the same Gumbel noise injected:
    rtol = atol = 1e-5 (the encode is exact; the critic's float32
    products are summed in another order)."""
    from repro_torch.privacy import discriminator_scores

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, ds, enc, _, st, card = _dp_setup(cuda)
    enc_card = type(enc)(enc.schema, enc.label_encoders, {
        j: type(p)(*(getattr(p, f).to(cuda)
                     for f in ("weights", "means", "stds", "valid")))
        for j, p in enc.vgms.items()}, cuda)
    rows = ds.data[:500]
    gumbel = enc.plan().draw_gumbel(len(rows),
                                    torch.Generator().manual_seed(9))
    want = discriminator_scores(st.disc, rows, enc, cfg, gumbel=gumbel)
    with ops.dispatch_scope() as d:
        got = discriminator_scores(card.disc, rows, enc_card, cfg,
                                   gumbel=gumbel.to(cuda))
    assert dict(d) == {"vgm_encode_table": 1}
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _small_federation(device, n_clients):
    from repro_torch.fed import setup_federation
    from repro_torch.gan.ctgan import CTGANConfig
    from repro_torch.tabular import make_dataset, partition_iid

    cfg = CTGANConfig(z_dim=16, gen_hidden=(32, 32), disc_hidden=(32, 32),
                      pac=4, batch_size=64)
    ds = make_dataset("adult", n_rows=1200, seed=5)
    parts = partition_iid(ds, n_clients, seed=5)
    return cfg, setup_federation(parts, ds.schema, cfg, 5, "fedtgan",
                                 device=device)


@pytest.mark.parametrize("faulted", [False, True])
def test_chunked_round_on_the_card_is_bit_identical_to_dense(cuda, faulted):
    """One round of 4 clients dense and with ``client_chunk=2`` from clones
    of one start on the card: every parameter and metric bit-identical,
    one merge launch each (the clients run one at a time either way)."""
    from repro_torch.core.architectures import _clone_states
    from repro_torch.fed import FaultPlan, FederatedProgram, build_fault_plan

    cfg, fe = _small_federation(cuda, 4)
    plan = build_fault_plan("chaos", 1, 4, seed=1)
    out = []
    for chunk in (None, 2):
        prog = FederatedProgram(cfg, fe.spans, fe.cond_spans,
                                batch=cfg.batch_size, local_steps=2,
                                client_chunk=chunk)
        states = _clone_states(fe.states)
        with ops.dispatch_scope() as d:
            if faulted:
                _, m = prog.faulted_round(states, fe.tables, fe.weights,
                                          FaultPlan(*(x[0] for x in plan)))
            else:
                _, m = prog.weighted_round(states, fe.tables, fe.weights)
            torch.cuda.synchronize()
        assert d["weighted_agg"] == 1 and d["segment_activations_bwd"] == 8
        out.append((states, m))
    (dense, dm), (chunked, cm) = out
    for k in dm:
        assert torch.equal(dm[k], cm[k]), k
    for a, b in zip(dense, chunked):
        for x, y in zip(a.params(), b.params()):
            assert torch.equal(x, y)


def test_collective_round_on_nccl_matches_global_round(cuda, tmp_path):
    """``shard_map_global_round`` on an NCCL group of one rank (a file
    store) against ``FederatedProgram.global_round`` from a clone of one
    client's start: bit-identical (the weight is 1, the all-reduce of one
    rank returns its input); the group is destroyed whatever happens."""
    import torch.distributed as dist

    from repro_torch.core.architectures import _clone_states
    from repro_torch.fed import FederatedProgram, shard_map_global_round

    cfg, fe = _small_federation(cuda, 1)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        states = _clone_states(fe.states)
        with ops.dispatch_scope() as d:
            _, m = shard_map_global_round(
                cfg, fe.spans, fe.cond_spans, batch=cfg.batch_size,
                local_steps=2)(states, fe.tables, fe.S, fe.n_rows)
            torch.cuda.synchronize()
        assert "weighted_agg" not in d and d["segment_activations_bwd"] == 2
    finally:
        dist.destroy_process_group()
    ref = _clone_states(fe.states)
    _, rm = FederatedProgram(cfg, fe.spans, fe.cond_spans,
                             batch=cfg.batch_size, local_steps=2
                             ).global_round(ref, fe.tables, fe.S, fe.n_rows)
    for k in rm:
        assert torch.equal(m[k], rm[k]), k
    for a, b in zip(states[0].params(), ref[0].params(), strict=True):
        assert torch.equal(a, b)
