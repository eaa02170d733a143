"""The recurrent blocks, the port's copy of the JAX package's
``models/ssm.py``: Mamba (jamba) and xLSTM's mLSTM and sLSTM.

* Mamba: a depthwise causal convolution, then the selective scan, a
  diagonal linear recurrence over a (B, d_inner, state) float32 state,
  run as a Python loop over time (the reference's ``lax.scan``; it has no
  Pallas kernel, and a fused scan kernel would be new work, ROADMAP).
  ``mamba_decode`` advances the state by one token through a bfloat16
  window of the last ``ssm_conv`` inputs, as the reference's does.
* mLSTM, the matrix-memory cell: ``mlstm_block`` runs it chunkwise
  (quadratic within a chunk, recurrent across chunks) through
  :func:`repro_torch.kernels.ops.mlstm_chunk`, the hand-written CUDA
  kernel on the card and its plain version on the CPU, with the ``(B, S, H,
  hd)`` <-> ``(B*H, S, hd)`` transposes around it; the output gate and
  the out projection stay outside, as in the reference.  The per-step
  ``mlstm_scan_ref`` is the oracle; ``mlstm_decode`` advances the state by
  one token.
* sLSTM, the scalar-memory cell with head-local recurrent mixing: its
  stabilized exponential gating is a nonlinear recurrence, a Python loop
  over time here (the reference's ``lax.scan``; its ``unroll=8`` changes
  no value).

States are NamedTuples of float32 tensors, as the reference's, but for
``MambaState.conv_buf``, bfloat16 in any model dtype.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig
from .layers import dense_init


# ===========================================================================
# Mamba
# ===========================================================================

def init_mamba(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> dict:
    D = cfg.d_model
    di = D * cfg.ssm_expand
    st = cfg.ssm_state
    dev = generator.device
    f32 = dict(dtype=torch.float32, device=dev)
    conv = torch.randn((di, cfg.ssm_conv), generator=generator, **f32)
    return {
        "ssm_in": dense_init(generator, D, di, dtype),
        "ssm_gate": dense_init(generator, D, di, dtype),
        "ssm_conv": (conv / math.sqrt(cfg.ssm_conv)).to(dtype),
        "ssm_bc": dense_init(generator, di, 2 * st, dtype),
        "ssm_dt": dense_init(generator, di, 1, torch.float32),
        "ssm_dt_bias": torch.full((di,), -2.0, **f32),     # softplus ~ 0.12
        "ssm_a": torch.log(torch.arange(1, st + 1, **f32).repeat(di, 1)),
        "ssm_d": torch.ones((di,), **f32),
        "ssm_out": dense_init(generator, di, D, dtype),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u (B, S, di), w (di, k): the depthwise causal convolution, summed
    tap by tap in u's dtype, as the reference does."""
    k, S = w.shape[1], u.shape[1]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = torch.zeros_like(u)
    for i in range(k):
        out = out + pad[:, i:i + S, :] * w[:, i][None, None, :]
    return out


class MambaState(NamedTuple):
    h: torch.Tensor          # (B, di, st) float32
    conv_buf: torch.Tensor   # (B, k-1, di) bfloat16, the last inputs


def init_mamba_state(cfg: ModelConfig, batch: int, *,
                     device: torch.device | str = "cuda") -> MambaState:
    di = cfg.d_model * cfg.ssm_expand
    return MambaState(
        torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32,
                    device=device),
        torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=torch.bfloat16,
                    device=device))


def _ssm_inputs(p: dict, uf: torch.Tensor, st: int):
    """dt (softplus), B and C of the selective scan from the float32
    convolved inputs, and A = -exp(ssm_a)."""
    dt = F.softplus(uf * p["ssm_dt"][:, 0] + p["ssm_dt_bias"])
    bc = uf @ p["ssm_bc"].float()
    return dt, bc[..., :st], bc[..., st:], -torch.exp(p["ssm_a"])


def mamba_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False):
    """x (B, S, D) -> (B, S, D): the selective scan over the sequence, one
    step per token.  ``return_state``: also the :class:`MambaState` after
    the last token (the prefill path)."""
    B, S, _ = x.shape
    st = cfg.ssm_state
    u_pre = x @ p["ssm_in"]                                    # (B, S, di)
    z = x @ p["ssm_gate"]
    uf = F.silu(_causal_conv(u_pre, p["ssm_conv"])).float()
    dt, Bm, Cm, A = _ssm_inputs(p, uf, st)
    dtu = dt * uf
    h = torch.zeros((B, uf.shape[-1], st), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t, :, None] * A)               # (B, di, st)
        h = decay * h + dtu[:, t, :, None] * Bm[:, t, None, :]
        ys.append(torch.sum(h * Cm[:, t, None, :], dim=-1))
    y = torch.stack(ys, dim=1) + uf * p["ssm_d"]
    out = (y.to(x.dtype) * F.silu(z)) @ p["ssm_out"]
    if not return_state:
        return out
    k = cfg.ssm_conv
    tail = (u_pre[:, S - (k - 1):] if S >= k - 1
            else F.pad(u_pre, (0, 0, k - 1 - S, 0)))
    return out, MambaState(h, tail.to(torch.bfloat16))


def mamba_decode(p: dict, x: torch.Tensor, state: MambaState,
                 cfg: ModelConfig) -> tuple[torch.Tensor, MambaState]:
    """One-token step: x (B, 1, D) -> (B, 1, D) and the next state.  The
    new input joins the window in the buffer's bfloat16, and the
    convolution reads the window back in float32."""
    st = cfg.ssm_state
    u = (x @ p["ssm_in"])[:, 0]                                # (B, di)
    z = (x @ p["ssm_gate"])[:, 0]
    window = torch.cat([state.conv_buf,
                        u[:, None, :].to(state.conv_buf.dtype)], dim=1)
    conv = torch.sum(window.float() * p["ssm_conv"].t()[None].float(), dim=1)
    uf = F.silu(conv)
    dt, b_t, c_t, A = _ssm_inputs(p, uf, st)
    decay = torch.exp(dt[..., None] * A)
    h = decay * state.h + (dt * uf)[..., None] * b_t[:, None, :]
    y = torch.sum(h * c_t[:, None, :], dim=-1) + uf * p["ssm_d"]
    out = (y.to(x.dtype) * F.silu(z))[:, None, :] @ p["ssm_out"]
    return out, MambaState(h, window[:, 1:])


# ===========================================================================
# mLSTM (xLSTM matrix-memory cell)
# ===========================================================================

def init_mlstm(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    di = D * cfg.ssm_expand
    return {
        "wq": dense_init(generator, D, di, dtype),
        "wk": dense_init(generator, D, di, dtype),
        "wv": dense_init(generator, D, di, dtype),
        "gate_i": dense_init(generator, D, H, torch.float32, 0.01),
        "gate_f": dense_init(generator, D, H, torch.float32, 0.01),
        "gate_o": dense_init(generator, D, H, torch.float32, 0.01),
        "wo": dense_init(generator, di, D, dtype),
    }


def _mlstm_inputs(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """q (pre-scaled), k, v (B, S, H, hd) and the log forget gate, the
    pre-exponential input gate and the output gate (B, S, H), float32."""
    B, S, D = x.shape
    H = cfg.n_heads
    hd = D * cfg.ssm_expand // H
    q = (x @ p["wq"]).reshape(B, S, H, hd).float() / math.sqrt(hd)
    k = (x @ p["wk"]).reshape(B, S, H, hd).float()
    v = (x @ p["wv"]).reshape(B, S, H, hd).float()
    xf = x.float()
    log_f = F.logsigmoid(xf @ p["gate_f"])
    log_i = xf @ p["gate_i"]
    o = torch.sigmoid(xf @ p["gate_o"])
    return q, k, v, log_f, log_i, o


def mlstm_scan_ref(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The per-step stabilized recurrence, the oracle of the chunkwise
    path."""
    q, k, v, log_f, log_i, o = _mlstm_inputs(p, x, cfg)
    B, S, H, hd = q.shape
    state = init_mlstm_state(cfg, B, device=x.device)
    hs = []
    for t in range(S):
        state, h = _mlstm_step(state, q[:, t], k[:, t], v[:, t], log_f[:, t],
                               log_i[:, t])
        hs.append(h)
    h = torch.stack(hs, dim=1) * o[..., None]
    return h.reshape(B, S, -1).to(x.dtype) @ p["wo"]


def mlstm_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False):
    """Chunkwise mLSTM over x (B, S, D) -> (B, S, D), chunks of
    ``min(cfg.mlstm_chunk, S)`` steps through ``ops.mlstm_chunk`` (one
    launch on the card).  ``return_state``: also the :class:`MLSTMState`
    after the last token (the prefill path)."""
    q, k, v, log_f, log_i, o = _mlstm_inputs(p, x, cfg)
    B, S, H, hd = q.shape
    L = min(cfg.mlstm_chunk, S)
    assert S % L == 0, (S, L)

    def heads_first(a):                        # (B, S, H, ...) -> (B*H, S, ...)
        return a.transpose(1, 2).reshape(B * H, S, *a.shape[3:]).contiguous()

    out = ops.mlstm_chunk(heads_first(q), heads_first(k), heads_first(v),
                          heads_first(log_f), heads_first(log_i), chunk=L,
                          return_state=return_state)
    h, carry = out if return_state else (out, None)
    h = h.reshape(B, H, S, hd).transpose(1, 2) * o[..., None]
    y = h.reshape(B, S, -1).to(x.dtype) @ p["wo"]
    if return_state:
        C, n, m = carry
        return y, MLSTMState(C.reshape(B, H, hd, hd), n.reshape(B, H, hd),
                             m.reshape(B, H))
    return y


class MLSTMState(NamedTuple):
    C: torch.Tensor     # (B, H, hd, hd) float32
    n: torch.Tensor     # (B, H, hd)
    m: torch.Tensor     # (B, H)


def init_mlstm_state(cfg: ModelConfig, batch: int, *,
                     device: torch.device | str = "cuda") -> MLSTMState:
    H = cfg.n_heads
    hd = cfg.d_model * cfg.ssm_expand // H
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(torch.zeros((batch, H, hd, hd), **f32),
                      torch.zeros((batch, H, hd), **f32),
                      torch.zeros((batch, H), **f32))


def _mlstm_step(state: MLSTMState, q, k, v, lf, li
                ) -> tuple[MLSTMState, torch.Tensor]:
    """One step of the stabilized recurrence: q, k, v (B, H, hd), lf, li
    (B, H) -> the new state and h (B, H, hd) before the output gate."""
    C, n, m = state
    m_new = torch.maximum(lf + m, li)
    fg = torch.exp(lf + m - m_new)
    ig = torch.exp(li - m_new)
    C = fg[..., None, None] * C + ig[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = fg[..., None] * n + ig[..., None] * k
    num = (q[..., None, :] @ C)[..., 0, :]
    den = torch.maximum(torch.abs(torch.sum(n * q, dim=-1)), torch.exp(-m_new))
    return MLSTMState(C, n, m_new), num / den[..., None]


def mlstm_decode(p: dict, x: torch.Tensor, state: MLSTMState,
                 cfg: ModelConfig) -> tuple[torch.Tensor, MLSTMState]:
    """One-token step: x (B, 1, D) -> (B, 1, D) and the next state."""
    q, k, v, log_f, log_i, o = _mlstm_inputs(p, x, cfg)      # S == 1
    state, h = _mlstm_step(state, q[:, 0], k[:, 0], v[:, 0], log_f[:, 0],
                           log_i[:, 0])
    h = h * o[:, 0, :, None]
    out = h.reshape(x.shape[0], 1, -1).to(x.dtype) @ p["wo"]
    return out, state


# ===========================================================================
# sLSTM (xLSTM scalar-memory cell with recurrent head-local mixing)
# ===========================================================================

def init_slstm(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    hd = D // H
    r = torch.randn((H, hd, 4 * hd), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return {"slstm_wx": dense_init(generator, D, 4 * D, dtype),
            "slstm_r": r / math.sqrt(hd)}


class SLSTMState(NamedTuple):
    h: torch.Tensor     # (B, H, hd) float32
    c: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor


def init_slstm_state(cfg: ModelConfig, batch: int, *,
                     device: torch.device | str = "cuda") -> SLSTMState:
    H = cfg.n_heads
    hd = cfg.d_model // H
    return SLSTMState(*(torch.zeros((batch, H, hd), dtype=torch.float32,
                                    device=device) for _ in range(4)))


def _slstm_step(state: SLSTMState, wx_t: torch.Tensor, r: torch.Tensor,
                H: int, hd: int) -> tuple[SLSTMState, torch.Tensor]:
    """wx_t: (B, 4D) input preactivations."""
    B = wx_t.shape[0]
    rec = (state.h.transpose(0, 1) @ r).transpose(0, 1)     # (B, H, 4hd)
    pre = wx_t.reshape(B, H, 4 * hd) + rec
    z, i, f, o = torch.split(pre, hd, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    log_f = F.logsigmoid(f)
    m_new = torch.maximum(log_f + state.m, i)
    ig = torch.exp(i - m_new)
    fg = torch.exp(log_f + state.m - m_new)
    c = fg * state.c + ig * z
    n = torch.maximum(fg * state.n + ig, torch.exp(-m_new))
    h = o * c / n
    return SLSTMState(h, c, n, m_new), h


def slstm_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False):
    """x (B, S, D) -> (B, S, D), one recurrence step per token;
    ``return_state``: also the :class:`SLSTMState` after the last token."""
    B, S, D = x.shape
    H = cfg.n_heads
    hd = D // H
    wx = (x @ p["slstm_wx"]).float()                          # (B, S, 4D)
    st = init_slstm_state(cfg, B, device=x.device)
    hs = []
    for t in range(S):
        st, h = _slstm_step(st, wx[:, t], p["slstm_r"], H, hd)
        hs.append(h)
    out = torch.stack(hs, dim=1).reshape(B, S, D).to(x.dtype)
    if return_state:
        return out, st
    return out


def slstm_decode(p: dict, x: torch.Tensor, state: SLSTMState,
                 cfg: ModelConfig) -> tuple[torch.Tensor, SLSTMState]:
    B, _, D = x.shape
    H = cfg.n_heads
    hd = D // H
    wx = (x[:, 0] @ p["slstm_wx"]).float()
    state, h = _slstm_step(state, wx, p["slstm_r"], H, hd)
    return h.reshape(B, 1, D).to(x.dtype), state
