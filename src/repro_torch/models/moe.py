"""The dense SwiGLU feed-forward block, the port's copy of
``init_dense_ffn`` and ``dense_ffn`` of the JAX package's
``models/moe.py``.  The mixture-of-experts FFN is not ported yet
(ROADMAP): :class:`repro_torch.models.Transformer` refuses configs with
experts."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import dense_init


def init_dense_ffn(generator: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    s_in, s_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Fd)
    return {"w_gate": dense_init(generator, D, Fd, dtype, s_in),
            "w_up": dense_init(generator, D, Fd, dtype, s_in),
            "w_down": dense_init(generator, Fd, D, dtype, s_out)}


def dense_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x W_gate) * (x W_up)) W_down``."""
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
