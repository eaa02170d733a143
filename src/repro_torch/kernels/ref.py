"""Plain-PyTorch versions of the port's CUDA kernels.

Each function mirrors the signature and op order of its counterpart in the
JAX package's ``kernels/ref.py``.  They are the CPU route of
:mod:`repro_torch.kernels.ops` and the yardstick every CUDA kernel is held
against on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30

# Gumbel-noise epsilon shared by the activation loop oracle
# (gan.ctgan.apply_activations), this module and the CUDA kernel.
GUMBEL_EPS = 1e-20

_HALF_LOG2PI = 0.5 * math.log(2 * math.pi)


def vgm_encode_table_ref(x_cols: torch.Tensor, means: torch.Tensor,
                         stds: torch.Tensor, log_weights: torch.Tensor,
                         gumbel: torch.Tensor) -> torch.Tensor:
    """x_cols (N, Q); means/stds/log_weights (Q, K) packed per-column
    params (padded modes carry log_weights=-1e30); gumbel (N, Q*K).
    Returns slots (N, Q*(1+K)): per column ``[alpha, beta_0..beta_{K-1}]``.
    """
    N, Q = x_cols.shape
    K = means.shape[1]
    g = gumbel.reshape(N, Q, K)
    xf = x_cols.float()
    z = (xf[:, :, None] - means[None]) / stds[None]
    log_pdf = -0.5 * z * z - torch.log(stds)[None] - _HALF_LOG2PI
    comp = torch.argmax(log_pdf + log_weights[None] + g, dim=2)      # (N, Q)
    mu = torch.gather(means.expand(N, Q, K), 2, comp[:, :, None])[:, :, 0]
    sd = torch.gather(stds.expand(N, Q, K), 2, comp[:, :, None])[:, :, 0]
    alpha = torch.clamp((xf - mu) / (4.0 * sd), -1.0, 1.0)
    beta = torch.nn.functional.one_hot(comp, K).float()              # (N, Q, K)
    return torch.cat([alpha[:, :, None], beta], dim=2).reshape(N, Q * (1 + K))


def vgm_encode_ref(x: torch.Tensor, means: torch.Tensor, stds: torch.Tensor,
                   log_weights: torch.Tensor, gumbel: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """One column: x (N,); means/stds/log_weights (K,) (invalid modes carry
    log_weights=-1e30); gumbel (N, K).  Returns alpha (N,) and the one-hot
    beta (N, K), the Q = 1 case of :func:`vgm_encode_table_ref`."""
    xf = x.float()
    z = (xf[:, None] - means[None, :]) / stds[None, :]
    log_pdf = -0.5 * z * z - torch.log(stds)[None, :] - _HALF_LOG2PI
    comp = torch.argmax(log_pdf + log_weights[None, :] + gumbel, dim=1)
    alpha = torch.clamp((xf - means[comp]) / (4.0 * stds[comp]), -1.0, 1.0)
    beta = torch.nn.functional.one_hot(comp, means.shape[0]).float()
    return alpha, beta


def vgm_decode_table_ref(slots: torch.Tensor, means: torch.Tensor,
                         stds: torch.Tensor) -> torch.Tensor:
    """slots (N, Q*(1+K)) per-column ``[alpha, beta_0..beta_{K-1}]``
    (padded beta lanes hold -1e30); means/stds (Q, K).  Returns (N, Q).
    No fused multiply-add: ``clip(alpha) * 4 * sd`` is rounded before
    ``+ mu``."""
    N = slots.shape[0]
    Q, K = means.shape
    s = slots.reshape(N, Q, 1 + K)
    comp = torch.argmax(s[:, :, 1:], dim=2)
    mu = torch.gather(means.expand(N, Q, K), 2, comp[:, :, None])[:, :, 0]
    sd = torch.gather(stds.expand(N, Q, K), 2, comp[:, :, None])[:, :, 0]
    return torch.clamp(s[:, :, 0], -1.0, 1.0) * 4.0 * sd + mu


def segment_activations_ref(packed_x: torch.Tensor, packed_u: torch.Tensor,
                            kinds: torch.Tensor, tau: float,
                            hard: bool = False) -> torch.Tensor:
    """packed_x (N, S*W) logits in span-slot layout (-inf padded lanes);
    packed_u (N, S*W) uniforms (padded lanes in (0, 1)); kinds (S, W) rows
    of 1.0 for tanh spans.  Returns packed activations (N, S*W).  The
    straight-through forward is ``(onehot - y) + y`` in that association,
    as in the reference, with ``y`` detached in the first term so that
    autograd passes the soft gradient (the reference's ``stop_gradient``).
    """
    N = packed_x.shape[0]
    S, W = kinds.shape
    x = packed_x.reshape(N, S, W).float()
    u = packed_u.reshape(N, S, W).float()
    g = -torch.log(-torch.log(u + GUMBEL_EPS) + GUMBEL_EPS)
    z = (x + g) / tau
    # jax.nn.softmax's chain (max, exp, sum, divide), written out: torch's
    # own softmax may multiply by the reciprocal of the sum instead.  The
    # max takes no gradient there either.
    e = torch.exp(z - torch.amax(z, dim=2, keepdim=True).detach())
    y = e / torch.sum(e, dim=2, keepdim=True)
    if hard:
        onehot = torch.nn.functional.one_hot(torch.argmax(y, dim=2), W).float()
        y = (onehot - y.detach()) + y
    out = torch.where(kinds[None] > 0.5, torch.tanh(x), y)
    return out.reshape(N, S * W)


def segment_activations_bwd_ref(packed_x: torch.Tensor,
                                packed_u: torch.Tensor, kinds: torch.Tensor,
                                ct: torch.Tensor, tau: float,
                                hard: bool = False) -> torch.Tensor:
    """The gradient w.r.t. ``packed_x`` of :func:`segment_activations_ref`
    for the upstream gradient ``ct`` (N, S*W), by autograd.  Tanh lanes give
    ``ct * (1 - tanh(x)^2)``, softmax lanes ``y * (ct - sum(ct * y)) / tau``
    of the soft sample (in hard mode too), padded lanes 0."""
    with torch.enable_grad():
        x = packed_x.detach().requires_grad_()
        out = segment_activations_ref(x, packed_u, kinds, tau, hard)
        (grad,) = torch.autograd.grad(out, x, ct)
    return grad


def weighted_agg_ref(stacked: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """stacked (P, D), weights (P,) -> (D,): the weighted average with the
    weights normalized as ``w / max(sum(w), 1e-12)``, in float32."""
    w = weights.float() / torch.clamp(torch.sum(weights.float()), min=1e-12)
    return torch.sum(stacked.float() * w[:, None], dim=0)


def weighted_agg_edges_ref(stacked: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """stacked (E, C, D), weights (E, C) -> (E, D): :func:`weighted_agg_ref`
    for every edge; an edge whose weights are all 0 gives zeros."""
    w = weights.float()
    w = w / torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1e-12)
    return torch.sum(stacked.float() * w[:, :, None], dim=1)


def _flash_mask(sq: int, sk: int, kv_len: int, causal: bool,
                window: int | None, device) -> torch.Tensor:
    """(Sq, Sk) bool: key j is visible to query i (and is not padding)."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    ok = k_pos < kv_len
    if causal:
        ok = ok & (k_pos <= q_pos)
    if window is not None:
        ok = ok & (k_pos > q_pos - window)
    return ok


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, causal: bool, window: int | None,
                            kv_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The flash forward over padded, head-matched inputs q (B, H, Sq, hd),
    k/v (B, H, Sk, hd); keys at or past ``kv_len`` are padding.  Returns
    out (B, H, Sq, hd) in q's dtype and lse (B, H, Sq) float32.

    The Pallas body's arithmetic without its tiling: q is scaled by
    1/sqrt(hd) before the product, masked scores are -1e30 (finite, so a
    fully masked row stays finite), and ``out = acc / max(l, 1e-30)``,
    ``lse = m + log(max(l, 1e-30))``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = (q.float() * scale) @ k.float().transpose(-1, -2)
    ok = _flash_mask(q.shape[2], k.shape[2], kv_len, causal, window, q.device)
    s = torch.where(ok, s, NEG_INF)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    denom = torch.clamp(torch.sum(p, dim=-1), min=1e-30)
    out = (p @ v.float()) / denom[..., None]
    return out.to(q.dtype), m + torch.log(denom)


def flash_attention_dq_ref(q, k, v, do, lse, delta, *, causal: bool,
                           window: int | None, kv_len: int) -> torch.Tensor:
    """dq (float32) of the flash forward for the upstream gradient ``do``
    (in q's dtype), the forward's ``lse`` and ``delta = sum(do * out,
    -1)``: ``p = exp(s - lse)`` with q scaled before the product, ``ds =
    p * (do v^T - delta)``, ``dq = (ds k) / sqrt(hd)``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = (q.float() * scale) @ k.float().transpose(-1, -2)
    ok = _flash_mask(q.shape[2], k.shape[2], kv_len, causal, window, q.device)
    p = torch.exp(torch.where(ok, s, NEG_INF) - lse[..., None])
    dp = do.float() @ v.float().transpose(-1, -2)
    ds = p * (dp - delta[..., None])
    return (ds @ k.float()) * scale


def flash_attention_dkv_ref(q, k, v, do, lse, delta, *, causal: bool,
                            window: int | None, kv_len: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) (float32) of the flash forward, as the Pallas dk/dv body
    computes them: the scores scaled AFTER the unscaled product, ``dv =
    p^T do``, ``dk = (ds^T q) / sqrt(hd)``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    ok = _flash_mask(q.shape[2], k.shape[2], kv_len, causal, window, q.device)
    p = torch.exp(torch.where(ok, s, NEG_INF) - lse[..., None])
    dof = do.float()
    dv = p.transpose(-1, -2) @ dof
    dp = dof @ v.float().transpose(-1, -2)
    ds = p * (dp - delta[..., None])
    dk = (ds.transpose(-1, -2) @ q.float()) * scale
    return dk, dv


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: int | None = None) -> torch.Tensor:
    """q (B, H, Sq, hd); k, v (B, Kh, Sk, hd): full-matrix softmax
    attention, KV head h // (H // Kh) for query head h."""
    B, H, Sq, hd = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    k = torch.repeat_interleave(k, H // Kh, dim=1)
    v = torch.repeat_interleave(v, H // Kh, dim=1)
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
    s = torch.where(_flash_mask(Sq, Sk, Sk, causal, window, q.device), s,
                    NEG_INF)
    return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)


def mlstm_chunk_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_f: torch.Tensor, log_i: torch.Tensor) -> torch.Tensor:
    """The per-step stabilized mLSTM recurrence, the oracle of the chunkwise
    forms (the reference's ``kernels/ref.py:mlstm_chunk_ref``).

    q/k/v (BH, S, hd), q pre-scaled; log_f/log_i (BH, S).  Returns the
    normalized hidden states (BH, S, hd) in q's dtype."""
    BH, S, hd = q.shape
    C = torch.zeros((BH, hd, hd), dtype=torch.float32, device=q.device)
    n = torch.zeros((BH, hd), dtype=torch.float32, device=q.device)
    m = torch.zeros((BH,), dtype=torch.float32, device=q.device)
    qf, kf, vf = q.float(), k.float(), v.float()
    lf_all, li_all = log_f.float(), log_i.float()
    hs = []
    for t in range(S):
        q_t, k_t, v_t = qf[:, t], kf[:, t], vf[:, t]
        lf, li = lf_all[:, t], li_all[:, t]
        m_new = torch.maximum(lf + m, li)
        fg = torch.exp(lf + m - m_new)[:, None, None]
        ig = torch.exp(li - m_new)[:, None, None]
        C = fg * C + ig * (k_t[:, :, None] * v_t[:, None, :])
        n = fg[:, :, 0] * n + ig[:, :, 0] * k_t
        num = torch.einsum("bde,bd->be", C, q_t)
        den = torch.maximum(torch.abs(torch.sum(n * q_t, -1)),
                            torch.exp(-m_new))
        m = m_new
        hs.append(num / den[:, None])
    return torch.stack(hs, dim=1).to(q.dtype)


def _mlstm_gates(lf: torch.Tensor, li: torch.Tensor, m: torch.Tensor,
                 tri: torch.Tensor):
    """One chunk's gates, the forward's arithmetic: the within-chunk
    cumulative log forget ``b``, the log weights of the causal (query, key)
    pairs, the rows' stabilizer ``m_pos``, the state term's weight, and the
    state update's stabilizer, carry weight and key weights."""
    b = torch.cumsum(lf, dim=1)
    logw = b[:, :, None] - b[:, None, :] + li[:, None, :]
    intra_max = torch.amax(torch.where(tri, logw, NEG_INF), dim=2)
    m_pos = torch.maximum(b + m[:, None], intra_max)
    inter_w = torch.exp(b + m[:, None] - m_pos)
    b_last = b[:, -1]
    m_new = torch.maximum(b_last + m, torch.amax(b_last[:, None] - b + li,
                                                 dim=1))
    carry_w = torch.exp(b_last + m - m_new)
    kv_w = torch.exp(b_last[:, None] - b + li - m_new[:, None])
    return logw, m_pos, inter_w, m_new, carry_w, kv_w


def mlstm_chunk_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_f: torch.Tensor, log_i: torch.Tensor, *,
                      chunk: int, return_state: bool = False):
    """The chunkwise mLSTM of the reference's ``models/ssm.py:mlstm_block``
    (its inner ``chunk`` step) on (BH, S, hd) tensors: per chunk of
    ``chunk`` steps the intra-chunk gated quadratic term plus the
    inter-chunk state term, with the (C, n, m) state carried across chunks
    from zeros.

    q (pre-scaled), k, v (BH, S, hd); log_f, log_i (BH, S); S a multiple of
    ``chunk``.  Returns h (BH, S, hd) float32, and with ``return_state``
    ``(h, (C (BH, hd, hd), n (BH, hd), m (BH,)))``, the state after the last
    step.  Masked (query, key) pairs get the finite -1e30 before the
    exponential, as the Pallas kernel masks its stabilizer, so they add
    exact zeros and no inf reaches autograd."""
    BH, S, hd = q.shape
    L = int(chunk)
    if L < 1 or S % L:
        raise ValueError(f"mlstm_chunk: S={S} is not a multiple of chunk={L}")
    dev = q.device
    qf, kf, vf = q.float(), k.float(), v.float()
    lf_all, li_all = log_f.float(), log_i.float()
    C = torch.zeros((BH, hd, hd), dtype=torch.float32, device=dev)
    n = torch.zeros((BH, hd), dtype=torch.float32, device=dev)
    m = torch.zeros((BH,), dtype=torch.float32, device=dev)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))
    hs = []
    for c0 in range(0, S, L):
        q_t, k_t, v_t = qf[:, c0:c0 + L], kf[:, c0:c0 + L], vf[:, c0:c0 + L]
        logw, m_pos, inter_w, m_new, carry_w, kv_w = _mlstm_gates(
            lf_all[:, c0:c0 + L], li_all[:, c0:c0 + L], m, tri)
        num_inter = (q_t @ C) * inter_w[..., None]
        den_inter = (q_t @ n[:, :, None])[..., 0] * inter_w
        w = torch.exp(torch.where(tri, logw - m_pos[:, :, None], NEG_INF))
        scores = (q_t @ k_t.transpose(1, 2)) * w
        num = num_inter + scores @ v_t
        den = torch.maximum(torch.abs(den_inter + torch.sum(scores, dim=2)),
                            torch.exp(-m_pos))
        hs.append(num / den[..., None])
        kw = k_t * kv_w[..., None]
        C = carry_w[:, None, None] * C + kw.transpose(1, 2) @ v_t
        n = carry_w[:, None] * n + torch.sum(kw, dim=1)
        m = m_new
    h = torch.cat(hs, dim=1) if hs else torch.zeros_like(qf)
    return (h, (C, n, m)) if return_state else h


def mlstm_chunk_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          log_f: torch.Tensor, log_i: torch.Tensor,
                          dh: torch.Tensor, *, chunk: int):
    """The gradient of :func:`mlstm_chunk_plain`'s h for the upstream
    gradient ``dh`` (BH, S, hd): ``(dq, dk, dv, dlog_f, dlog_i)``, float32,
    written out as the backward kernel computes it (the spec of
    ``csrc/mlstm_chunk_bwd.cu`` and its CPU route).

    In unstabilized terms h_i = N_i / max(|D_i|, 1): h depends on no
    stabilizer (the rows' ``m_pos``, the carried ``m``), so every
    stabilizer is a constant here, and a clamped denominator passes no
    gradient.  Per chunk, with the chunk-start state (C, n) recomputed by
    the forward's walk, ``X = dh C^T``, the raw scores ``q k^T``, gated to
    ``s`` by the causal weights ``w``, and ``A = dh v^T``:

      den_pre = iw (q.n) + sum_j s,  den = max(|den_pre|, exp(-m_pos))
      g = -(dh.num) sign(den_pre) / den^2 where |den_pre| > exp(-m_pos)
      dscores = A / den + g,  dq = (dscores w) k + iw (X / den + g n),
      dk = (dscores w)^T q,  dv = s^T (dh / den),
      d log w = dscores s,  d log iw = iw (q.X / den + g q.n)

    with ``dh.num = iw q.X + sum_j s A``.  A walk back over the chunks
    carries the state gradient, ``dC <- carry_w dC + (iw q / den)^T dh``
    and ``dn <- carry_w dn + (iw g)^T q``, into the keys' and values'
    state terms and the carry and key weights' log gradients.  The log
    gradients land on ``b`` (the within-chunk cumulative log forget) and
    on ``log_i``; ``dlog_f`` is the reverse cumulative sum of ``db``
    within each chunk."""
    BH, S, hd = q.shape
    L = int(chunk)
    if L < 1 or S % L:
        raise ValueError(f"mlstm_chunk: S={S} is not a multiple of chunk={L}")
    dev = q.device
    qf, kf, vf, dhf = q.float(), k.float(), v.float(), dh.float()
    lf_all, li_all = log_f.float(), log_i.float()
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))
    f32 = dict(dtype=torch.float32, device=dev)
    C = torch.zeros((BH, hd, hd), **f32)
    n = torch.zeros((BH, hd), **f32)
    m = torch.zeros((BH,), **f32)
    starts, gates = [], []
    for c0 in range(0, S, L):           # the chunk-start states
        sl = slice(c0, c0 + L)
        gate = _mlstm_gates(lf_all[:, sl], li_all[:, sl], m, tri)
        starts.append((C, n))
        gates.append(gate)
        _, _, _, m, carry_w, kv_w = gate
        kw = kf[:, sl] * kv_w[..., None]
        C = carry_w[:, None, None] * C + kw.transpose(1, 2) @ vf[:, sl]
        n = carry_w[:, None] * n + torch.sum(kw, dim=1)
    dq, dk, dv, db, dli, dstate = [], [], [], [], [], []
    for ci, c0 in enumerate(range(0, S, L)):    # each chunk's own terms
        sl = slice(c0, c0 + L)
        q_t, k_t, v_t, dh_t = qf[:, sl], kf[:, sl], vf[:, sl], dhf[:, sl]
        (C, n), (logw, m_pos, iw, _, _, _) = starts[ci], gates[ci]
        w = torch.exp(torch.where(tri, logw - m_pos[:, :, None], NEG_INF))
        s = (q_t @ k_t.transpose(1, 2)) * w
        A = torch.where(tri, dh_t @ v_t.transpose(1, 2), 0.0)
        X = dh_t @ C.transpose(1, 2)
        qn = (q_t @ n[:, :, None])[..., 0]
        qX = torch.sum(q_t * X, dim=2)
        den_pre = iw * qn + torch.sum(s, dim=2)
        floor = torch.exp(-m_pos)
        den = torch.maximum(torch.abs(den_pre), floor)
        hnum = iw * qX + torch.sum(s * A, dim=2)
        g = torch.where(torch.abs(den_pre) > floor,
                        -hnum * torch.sign(den_pre) / (den * den), 0.0)
        inv = 1.0 / den
        dscores = torch.where(tri, A * inv[..., None] + g[..., None], 0.0)
        ds = dscores * w
        P = dscores * s
        dq.append(ds @ k_t + iw[..., None] * (X * inv[..., None]
                                              + g[..., None] * n[:, None]))
        dk.append(ds.transpose(1, 2) @ q_t)
        dv.append(s.transpose(1, 2) @ (dh_t * inv[..., None]))
        db.append(iw * (qX * inv + g * qn) + torch.sum(P, dim=2)
                  - torch.sum(P, dim=1))
        dli.append(torch.sum(P, dim=1))
        dstate.append((q_t * (iw * inv)[..., None], iw * g))
    dC = torch.zeros((BH, hd, hd), **f32)    # into the state after a chunk
    dn = torch.zeros((BH, hd), **f32)
    for ci in reversed(range(S // L)):      # the walk back over the states
        sl = slice(ci * L, (ci + 1) * L)
        (C, n), (_, _, _, _, carry_w, kv_w) = starts[ci], gates[ci]
        if ci < S // L - 1:
            dk_state = kv_w[..., None] * (vf[:, sl] @ dC.transpose(1, 2)
                                          + dn[:, None])
            dk[ci] = dk[ci] + dk_state
            dv[ci] = dv[ci] + kv_w[..., None] * (kf[:, sl] @ dC)
            T = torch.sum(kf[:, sl] * dk_state, dim=2)
            U = carry_w * (torch.sum(C * dC, dim=(1, 2))
                           + torch.sum(n * dn, dim=1))
            last = (torch.sum(T, dim=1) + U)[:, None]
            db[ci] = torch.cat([db[ci][:, :-1] - T[:, :-1],
                                (db[ci][:, -1:] - T[:, -1:]) + last], dim=1)
            dli[ci] = dli[ci] + T
        qs, ig = dstate[ci]
        dC = carry_w[:, None, None] * dC + qs.transpose(1, 2) @ dhf[:, sl]
        dn = carry_w[:, None] * dn + torch.sum(ig[..., None] * qf[:, sl],
                                               dim=1)
    dq, dk, dv = (torch.cat(t, dim=1) for t in (dq, dk, dv))
    db, dli = torch.cat(db, dim=1), torch.cat(dli, dim=1)
    dlf = torch.flip(torch.cumsum(torch.flip(db.reshape(BH, -1, L), [2]),
                                  dim=2), [2]).reshape(BH, S)
    return dq, dk, dv, dlf, dli
