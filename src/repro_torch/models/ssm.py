"""xLSTM's recurrent blocks, the port's copy of the mLSTM and sLSTM parts
of the JAX package's ``models/ssm.py``.

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

States are NamedTuples of float32 tensors, as the reference's.  Mamba is
not ported yet (ROADMAP).
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
