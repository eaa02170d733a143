"""The tensor-core mLSTM kernel's precision design, emulated on the CPU.

``csrc/mlstm_chunk_sm90.cu`` runs every product of the chunkwise mLSTM on
bf16 tensor cores, each float32 operand split into two bf16 terms (hi =
bf16(x), lo = bf16(x - hi)) and each product taken as the three cross
products hi.hi + hi.lo + lo.hi into one float32 sum; it takes cumsum(log_f)
as a warp scan (each lane sums its consecutive steps in order, then a
shuffle scan of the lane totals).  These tests emulate that rounding in
plain PyTorch (bf16 products are exact in float32, so a float32 matmul of
the terms rounds as the tensor cores' float32 sums do, up to their order)
and hold the emulation to the card gates against the plain version
``mlstm_chunk_plain``: h, C and n rtol 1e-4, atol 2e-4, the stabilizer m
atol 1e-5 (``tests/test_torch_cuda.py``, ``chip_smoke.py``).  One term
(a single bf16 rounding of each operand) misses them, which is why the
kernel splits.  The emulation is also held against the JAX package's
Pallas kernel (interpret mode) at the reference's tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mlstm_chunk import mlstm_chunk as jmlstm_chunk  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from torch_kernel_inputs import as_tensors, mlstm_inputs  # noqa: E402

TERMS = 2          # the kernel's bf16 terms per float32 operand

# BH, S, hd, chunk, constant log_f: the card tests' shapes that fit the CPU
CASES = [
    (2, 64, 32, 16, None), (4, 128, 64, 32, None), (1, 256, 128, 128, None),
    (3, 96, 16, 32, None),
    (1, 32, 16, 16, -30.0),       # strong decay: the state resets every step
    (16, 512, 128, 32, None),     # the xlstm-1.3b smoke config's head dim
    (5, 256, 64, 256, None),      # one chunk, S == L
    (3, 36, 48, 12, None),        # ragged: L 12, hd 48, BH odd
    (1, 300, 32, 100, None),      # L not a multiple of 64
    (2, 384, 192, 192, None),
    (2, 512, 64, 256, -30.0),
    (2, 2048, 1024, 256, None),   # two heads of the full-width prefill
]


def _terms(x, n):
    """x as n bf16 terms: bf16(x), then bf16 of each remainder."""
    out = []
    for _ in range(n):
        t = x.to(torch.bfloat16).float()
        out.append(t)
        x = x - t
    return out


def _product(a, b, n):
    """a @ b from n bf16 terms of each, the products of terms t, u with
    t + u < n (3 of the 4 for two terms) summed in float32."""
    at, bt = _terms(a, n), _terms(b, n)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for t in range(n):
        for u in range(n - t):
            acc = acc + at[t] @ bt[u]
    return acc


def _warp_scan(f):
    """cumsum over a chunk's steps (BH, L) as the kernel's warp takes it:
    lane l sums steps l*per .. l*per + per - 1 in order (per = L / 32
    rounded up), a shuffle scan turns the lane totals into prefixes, and
    lane l > 0 adds its prefix to each of its partial sums."""
    BH, L = f.shape
    per = -(-L // 32)
    g = torch.nn.functional.pad(f, (0, 32 * per - L)).reshape(BH, 32, per)
    loc, s = [], torch.zeros(BH, 32)
    for u in range(per):
        s = s + g[:, :, u]
        loc.append(s)
    loc = torch.stack(loc, -1)
    x = s
    off = 1
    while off < 32:
        x = torch.cat([x[:, :off], x[:, off:] + x[:, :-off]], 1)
        off *= 2
    pre = torch.cat([torch.zeros(BH, 1), x[:, :-1]], 1)
    b = torch.cat([loc[:, :1], pre[:, 1:, None] + loc[:, 1:]], 1)
    return b.reshape(BH, 32 * per)[:, :L]


def emulate(q, k, v, log_f, log_i, chunk, terms=TERMS):
    """The kernel's arithmetic on (BH, S, hd) float32 tensors: returns h
    and the final (C, n, m)."""
    BH, S, hd = q.shape
    L = chunk
    C, n, m = torch.zeros(BH, hd, hd), torch.zeros(BH, hd), torch.zeros(BH)
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool))
    hs = []
    for c0 in range(0, S, L):
        qt, kt, vt = q[:, c0:c0 + L], k[:, c0:c0 + L], v[:, c0:c0 + L]
        li = log_i[:, c0:c0 + L]
        b = _warp_scan(log_f[:, c0:c0 + L])
        logw = (b[:, :, None] - b[:, None, :]) + li[:, None, :]
        m_pos = torch.maximum(b + m[:, None], torch.amax(
            torch.where(tri, logw, tref.NEG_INF), 2))
        inter_w = torch.exp((b + m[:, None]) - m_pos)
        w = torch.exp(torch.where(tri, logw - m_pos[:, :, None],
                                  tref.NEG_INF))
        scores = _product(qt, kt.transpose(1, 2), terms) * w
        qn = (qt @ n[:, :, None])[..., 0]
        den = torch.maximum(torch.abs(qn * inter_w + scores.sum(2)),
                            torch.exp(-m_pos))
        num = (_product(qt, C, terms) * inter_w[..., None]
               + _product(scores, vt, terms))
        hs.append(num / den[..., None])
        b_last = b[:, -1]
        m_new = torch.maximum(b_last + m, torch.amax(
            (b_last[:, None] - b) + li, 1))
        carry = torch.exp((b_last + m) - m_new)
        kw = kt * torch.exp(((b_last[:, None] - b) + li)
                            - m_new[:, None])[..., None]
        C = carry[:, None, None] * C + _product(kw.transpose(1, 2), vt, terms)
        n = carry[:, None] * n + kw.sum(1)
        m = m_new
    return torch.cat(hs, 1), (C, n, m)


def _inputs(BH, S, hd, log_f):
    return as_tensors(*mlstm_inputs(BH + S + hd, BH, S, hd, log_f=log_f))


def _misses(got, want):
    """The largest |got - want| over the card gate's atol + rtol |want|."""
    return float(((got - want).abs() / (2e-4 + 1e-4 * want.abs())).max())


@pytest.mark.parametrize("case", CASES)
def test_split_products_keep_the_card_gates(case):
    BH, S, hd, chunk, log_f = case
    args = _inputs(BH, S, hd, log_f)
    h, (C, n, m) = emulate(*args, chunk)
    p_h, (p_C, p_n, p_m) = tref.mlstm_chunk_plain(*args, chunk=chunk,
                                                  return_state=True)
    for got, want in ((h, p_h), (C, p_C), (n, p_n)):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-4)
    torch.testing.assert_close(m, p_m, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", [CASES[1], CASES[4], CASES[7], CASES[-1]])
def test_one_term_misses_the_card_gates(case):
    """A single bf16 rounding of each operand puts h and C tens of times
    outside the gates: the kernel needs the second term."""
    BH, S, hd, chunk, log_f = case
    args = _inputs(BH, S, hd, log_f)
    h, (C, _, _) = emulate(*args, chunk, terms=1)
    p_h, (p_C, _, _) = tref.mlstm_chunk_plain(*args, chunk=chunk,
                                              return_state=True)
    assert _misses(h, p_h) > 10 and _misses(C, p_C) > 10


def test_warp_scan_is_a_cumsum():
    """The scan's order gives the cumulative sum within float32 rounding,
    for every chunk length up to 256, and exactly on small integers."""
    rng = np.random.default_rng(0)
    for L in (1, 12, 31, 32, 33, 100, 255, 256):
        f = torch.from_numpy(rng.normal(size=(3, L)).astype(np.float32))
        torch.testing.assert_close(_warp_scan(f), torch.cumsum(f, 1),
                                   rtol=1e-5, atol=1e-5)
        ints = torch.from_numpy(rng.integers(-8, 8, (3, L)).astype(np.float32))
        assert torch.equal(_warp_scan(ints), torch.cumsum(ints, 1))


@pytest.mark.parametrize("case", [(2, 64, 32, 16, None), (3, 96, 16, 32, None),
                                  (1, 32, 16, 16, -30.0)])
def test_emulation_matches_the_pallas_kernel(case):
    """The emulated kernel against the JAX package's Pallas mlstm_chunk
    (interpret mode) at the reference's kernel-vs-oracle tolerance, rtol
    2e-3 and atol 2e-4 (``tests/test_torch_ssm.py``)."""
    BH, S, hd, chunk, log_f = case
    arrays = mlstm_inputs(BH + S + hd, BH, S, hd, log_f=log_f)
    h, _ = emulate(*as_tensors(*arrays), chunk)
    want = jmlstm_chunk(*map(jnp.asarray, arrays), chunk=chunk,
                        interpret=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-4)


if __name__ == "__main__":
    # How close the emulated kernel comes to the card gates at the xLSTM
    # prefill's full shape (16 heads; minutes on a CPU), drawn as the card
    # tests draw it:  PYTHONPATH=src:tests python tests/test_torch_mlstm_tc.py
    BH, S, hd, chunk = 16, 2048, 1024, 256
    args = _inputs(BH, S, hd, None)
    p_h, (p_C, p_n, p_m) = tref.mlstm_chunk_plain(*args, chunk=chunk,
                                                  return_state=True)
    for terms in (TERMS, TERMS + 1):
        h, (C, n, m) = emulate(*args, chunk, terms)
        print(f"({BH}, {S}, {hd}), L {chunk}, {terms} bf16 terms: of the "
              f"gate h {_misses(h, p_h):.3f}, C {_misses(C, p_C):.3f}, "
              f"n {_misses(n, p_n):.3f}, m {float((m - p_m).abs().max()) / 1e-5:.3f}; "
              f"max abs err h {float((h - p_h).abs().max()):.3g}")
