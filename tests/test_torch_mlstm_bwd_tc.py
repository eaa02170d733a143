"""The tensor-core mLSTM backward kernel's precision design, emulated on
the CPU.

``csrc/mlstm_chunk_bwd.cu`` runs every product of the chunkwise mLSTM's
backward on bf16 tensor cores, each float32 operand split into two bf16
terms (hi = bf16(x), lo = bf16(x - hi)) and each product taken as the
three cross products hi.hi + hi.lo + lo.hi into one float32 sum, as the
forward does (``tests/test_torch_mlstm_tc.py``); the raw scores q k^T take
three terms of q and k and the six cross products of terms t, u with
t + u < 3.  The operands are what
the kernel writes as bf16 planes: q, k, v, dh, k kv_w, q iw / den,
dh / den, the gated scores s and their gradient ds, the chunk-start
states C and the state gradients dC; the carry weight <C, dC> reads C
back from its planes.  Everything else is float32 with the plain
version's expressions, the gates the forward kernel's (its warp scan of
cumsum(log_f)).  These tests emulate that rounding in plain PyTorch
(bf16 products are exact in float32, so a float32 matmul of the terms
rounds as the tensor cores' float32 sums do, up to their order) and hold
it to the card gate against the plain backward ``mlstm_chunk_bwd_plain``:
each gradient within 1e-4 of the largest |plain gradient| entry, dlog_f
of dlog_i's (``tests/test_torch_cuda.py:_close_to_largest``,
``chip_smoke.py``'s ``mlstm_bwd_cases``).  One term misses it.  The
emulation is also held to ``jax.vjp`` of the JAX package's per-step
oracle at ``tests/test_torch_mlstm_bwd.py``'s tolerance.  One torch
thread.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import work  # noqa: E402
from test_torch_mlstm_tc import _product, _terms, _warp_scan  # noqa: E402
from torch_kernel_inputs import as_tensors, mlstm_inputs  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

NAMES = ("dq", "dk", "dv", "dlog_f", "dlog_i")
# the backward's products, by what they compute: the chunk-start states C,
# X = dh C^T, the raw scores q k^T, A = dh v^T, the intra-chunk ds k,
# ds^T q and s^T (dh / den), the state gradient dC and the keys' and
# values' state terms v dC^T and k dC
PRODUCTS = ("C", "X", "qk", "A", "dq", "dk", "dv", "dC", "dk_state",
            "dv_state")
# the kernel's bf16 terms per float32 operand of each product: two, and
# three for the raw scores, whose error the gates' exponentials carry into
# every gradient (with two terms there, the emulation misses the oracle's
# 2e-5 by up to 3.7x)
TERMS = dict.fromkeys(PRODUCTS, 2) | {"qk": 3}

# BH, S, hd, chunk, constant log_f: the card tests' backward shapes that
# fit the CPU (tests/test_torch_cuda.py MLSTM_BWD_CASES without the
# full-width prefill and training step), then two heads of the training
# step's (16, 512, 1024), L 256
CASES = [
    (2, 64, 32, 16, None), (4, 128, 64, 32, None), (1, 256, 128, 128, None),
    (3, 96, 16, 32, None),
    (1, 32, 16, 16, -30.0),       # strong decay: the state resets every step
    (16, 512, 128, 32, None),     # the xlstm-1.3b smoke config's head dim
    (5, 256, 64, 256, None),      # one chunk, S == L
    (3, 36, 48, 12, None),        # L and hd not powers of two, BH odd
    (1, 300, 32, 100, None),      # L not a multiple of 64
    (3, 260, 80, 130, None),
    (2, 384, 192, 192, None),
    (1, 768, 256, 256, None),
    (2, 512, 64, 256, -30.0),
    (2, 8, 32, 1, None),          # the tensor-core backward's tile edges
    (2, 192, 64, 64, None),
    (9, 512, 1024, 256, None),
    (2, 512, 1024, 256, None),    # two heads of the training step
]
TRAINING = CASES[-1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _joined(x, n):
    """What n bf16 terms of x hold: their float32 sum."""
    return sum(_terms(x, n))


def emulate_bwd(q, k, v, log_f, log_i, dh, chunk, terms=TERMS):
    """The backward kernel's arithmetic on (BH, S, hd) float32 tensors:
    ``(dq, dk, dv, dlog_f, dlog_i)``."""
    BH, S, hd = q.shape
    L, nc = chunk, S // chunk
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool))
    n_of = terms if isinstance(terms, dict) else dict.fromkeys(PRODUCTS,
                                                               terms)
    P = lambda a, b, name: _product(a, b, n_of[name])   # noqa: E731
    T = lambda x: x.transpose(1, 2)                 # noqa: E731
    sl = [slice(c * L, (c + 1) * L) for c in range(nc)]
    # gates (the forward kernel's), k kv_w, the chunk-start states
    m = torch.zeros(BH)
    gates, kws, Cs, ns = [], [], [], []
    C, n = torch.zeros(BH, hd, hd), torch.zeros(BH, hd)
    for c in range(nc):
        li = log_i[:, sl[c]]
        b = _warp_scan(log_f[:, sl[c]])
        logw = (b[:, :, None] - b[:, None, :]) + li[:, None, :]
        m_pos = torch.maximum(b + m[:, None], torch.amax(
            torch.where(tri, logw, tref.NEG_INF), 2))
        iw = torch.exp((b + m[:, None]) - m_pos)
        w = torch.exp(torch.where(tri, logw - m_pos[:, :, None],
                                  tref.NEG_INF))
        b_last = b[:, -1]
        m_new = torch.maximum(b_last + m, torch.amax(
            (b_last[:, None] - b) + li, 1))
        carry = torch.exp((b_last + m) - m_new)
        kvw = torch.exp(((b_last[:, None] - b) + li) - m_new[:, None])
        gates.append((m_pos, iw, w, carry, kvw))
        kw = k[:, sl[c]] * kvw[..., None]
        kws.append(kw)
        Cs.append(C)
        ns.append(n)
        if c < nc - 1:
            C = carry[:, None, None] * C + P(T(kw), v[:, sl[c]], "C")
            n = carry[:, None] * n + kw.sum(1)
        m = m_new
    # each chunk's own terms
    dq, dk, dv, db, dli, qss, igs = [], [], [], [], [], [], []
    for c in range(nc):
        qt, kt, vt, dht = q[:, sl[c]], k[:, sl[c]], v[:, sl[c]], dh[:, sl[c]]
        m_pos, iw, w, _, _ = gates[c]
        X = P(dht, T(Cs[c]), "X") if c else torch.zeros(BH, L, hd)
        qX = torch.sum(qt * X, 2)
        qn = (qt @ ns[c][:, :, None])[..., 0]
        s = P(qt, T(kt), "qk") * w
        A = torch.where(tri, P(dht, T(vt), "A"), 0.0)
        den_pre = iw * qn + s.sum(2)
        floor = torch.exp(-m_pos)
        den = torch.maximum(torch.abs(den_pre), floor)
        hnum = iw * qX + torch.sum(s * A, 2)
        g = torch.where(torch.abs(den_pre) > floor,
                        -(hnum * torch.sign(den_pre)) / (den * den), 0.0)
        inv = 1.0 / den
        dsc = torch.where(tri, A * inv[..., None] + g[..., None], 0.0)
        ds, Pm = dsc * w, dsc * s
        dq.append(P(ds, kt, "dq") + iw[..., None] * (
            X * inv[..., None] + g[..., None] * ns[c][:, None]))
        dk.append(P(T(ds), qt, "dk"))
        dv.append(P(T(s), dht * inv[..., None], "dv"))
        colP = Pm.sum(1)
        db.append(iw * (qX * inv + g * qn) + Pm.sum(2) - colP)
        dli.append(colP)
        qss.append(qt * (iw * inv)[..., None])
        igs.append(iw * g)
    # the walk back over the states
    dC, dn = torch.zeros(BH, hd, hd), torch.zeros(BH, hd)
    for c in reversed(range(nc)):
        _, _, _, carry, kvw = gates[c]
        if c < nc - 1:
            dks = kvw[..., None] * (P(v[:, sl[c]], T(dC), "dk_state")
                                    + dn[:, None])
            dk[c] = dks + dk[c]
            dv[c] = kvw[..., None] * P(k[:, sl[c]], dC, "dv_state") + dv[c]
            Tr = torch.sum(k[:, sl[c]] * dks, 2)
            U = carry * (torch.sum(_joined(Cs[c], n_of["C"]) * dC, (1, 2))
                         + torch.sum(ns[c] * dn, 1))
            db[c] = torch.cat([db[c][:, :-1] - Tr[:, :-1],
                               (db[c][:, -1:] - Tr[:, -1:])
                               + (Tr.sum(1) + U)[:, None]], 1)
            dli[c] = dli[c] + Tr
        if c:
            dC = (carry[:, None, None] * dC
                  + P(T(qss[c]), dh[:, sl[c]], "dC"))
            dn = carry[:, None] * dn + torch.sum(igs[c][..., None]
                                                 * q[:, sl[c]], 1)
    dq, dk, dv = (torch.cat(t, 1) for t in (dq, dk, dv))
    db, dli = torch.cat(db, 1), torch.cat(dli, 1)
    dlf = torch.flip(torch.cumsum(torch.flip(db.reshape(BH, nc, L), [2]), 2),
                     [2]).reshape(BH, S)
    return dq, dk, dv, dlf, dli


def _inputs(case):
    """The card test's draw (tests/test_torch_cuda.py:_mlstm_bwd_inputs)."""
    BH, S, hd, chunk, log_f = case
    args = as_tensors(*mlstm_inputs(BH + S + hd, BH, S, hd, log_f=log_f))
    dh = torch.from_numpy(np.random.default_rng(BH * S).normal(
        size=(BH, S, hd)).astype(np.float32))
    return args, dh, chunk


def of_the_gate(got, want, frac=1e-4):
    """Each gradient's largest |got - want| over ``frac`` of the largest
    |want| entry (dlog_f over dlog_i's scale too): 1 at the card gate."""
    scales = [float(w.abs().max()) for w in want]
    scales[3] = max(scales[3], scales[4])
    return {name: float((g - w).abs().max()) / (frac * max(s, 1e-30))
            for name, g, w, s in zip(NAMES, got, want, scales)}


@pytest.mark.parametrize("case", CASES)
def test_split_products_keep_the_card_gate(case):
    args, dh, chunk = _inputs(case)
    got = emulate_bwd(*args, dh, chunk)
    want = tref.mlstm_chunk_bwd_plain(*args, dh, chunk=chunk)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in got)
    ratios = of_the_gate(got, want)
    assert max(ratios.values()) <= 1.0, ratios


def test_one_term_misses_the_card_gate():
    """A single bf16 rounding of each operand puts the gradients outside
    the gate at the training step's width: the kernel needs the second
    term."""
    args, dh, chunk = _inputs(TRAINING)
    got = emulate_bwd(*args, dh, chunk, terms=1)
    want = tref.mlstm_chunk_bwd_plain(*args, dh, chunk=chunk)
    ratios = of_the_gate(got, want)
    assert min(ratios.values()) > 1.0, ratios


def test_split_work_counts_the_kernels_terms():
    """``work.mlstm_chunk_bwd_split`` counts the bf16 products these terms
    take: t (t + 1) / 2 cross products of t terms (three of two, six of
    three) on each product's least work, which stays
    ``work.mlstm_chunk_bwd``'s."""
    BH, S, hd, L = 16, 512, 1024, 256
    nch = S // L
    state = BH * 2 * L * hd * hd * (nch - 1)      # one state product
    causal = BH * 2 * hd * nch * L * (L + 1) // 2  # one causal half
    least = {p: state if p in ("C", "X", "dC", "dk_state", "dv_state")
             else causal for p in PRODUCTS}
    assert sum(least.values()) == work.mlstm_chunk_bwd(BH, S, hd, L)[1]
    done = sum(least[p] * TERMS[p] * (TERMS[p] + 1) // 2 for p in PRODUCTS)
    assert done == work.mlstm_chunk_bwd_split(BH, S, hd, L) == 167_654_719_488


ORACLE_CASES = CASES[:5]   # tests/test_torch_mlstm_bwd.py's shapes


def _oracle(case):
    """``tests/test_torch_mlstm_bwd.py``'s draw and ``jax.vjp`` of the
    reference's per-step oracle (``src/repro/kernels/ref.py:
    mlstm_chunk_ref``) on it: the inputs as tensors and the gradients."""
    BH, S, hd, chunk, log_f = case
    arrays = mlstm_inputs(BH * S + hd, BH, S, hd, log_f=log_f)
    dh = np.random.default_rng(BH + S).normal(size=(BH, S, hd)
                                              ).astype(np.float32)
    _, vjp = jax.vjp(jref.mlstm_chunk_ref, *map(jnp.asarray, arrays))
    want = [torch.from_numpy(np.array(w)) for w in vjp(jnp.asarray(dh))]
    return (*as_tensors(*arrays), torch.from_numpy(dh), chunk), want


@pytest.mark.parametrize("case", ORACLE_CASES)
def test_emulation_matches_jax_vjp_of_the_oracle(case):
    """The emulated kernel against the oracle's gradient at
    ``tests/test_torch_mlstm_bwd.py``'s tolerance: each gradient within
    2e-5 of its largest entry (dlog_f of dlog_i's)."""
    args, want = _oracle(case)
    ratios = of_the_gate(emulate_bwd(*args), want, 2e-5)
    assert max(ratios.values()) <= 1.0, ratios


def test_two_terms_of_the_raw_scores_miss_the_oracle():
    """With two terms of q and k in q k^T the emulation leaves the oracle's
    2e-5 on some shape: the raw scores take the third term."""
    worst = 0.0
    for case in ORACLE_CASES:
        args, want = _oracle(case)
        got = emulate_bwd(*args, terms=TERMS | {"qk": 2})
        worst = max(worst, max(of_the_gate(got, want, 2e-5).values()))
    assert worst > 1.0


if __name__ == "__main__":
    # How close the emulated kernel comes to the card gate at each case and
    # at the training step's full shape (16 heads; a minute on a CPU), with
    # one term, the kernel's terms, and three terms everywhere:
    #   PYTHONPATH=src:tests python tests/test_torch_mlstm_bwd_tc.py
    for case in CASES + [(16, 512, 1024, 256, None)]:
        args, dh, chunk = _inputs(case)
        want = tref.mlstm_chunk_bwd_plain(*args, dh, chunk=chunk)
        for name, terms in (("one term", 1), ("the kernel's", TERMS),
                            ("three terms", 3)):
            got = emulate_bwd(*args, dh, chunk, terms)
            print(case, f"{name}, of the gate:", ", ".join(
                f"{k} {r:.3f}" for k, r in of_the_gate(got, want).items()))
