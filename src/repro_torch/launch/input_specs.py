"""Meta-tensor stand-ins for every model input, the port's copy of the JAX
package's ``launch/input_specs.py`` (there ``ShapeDtypeStruct``s): shapes
and dtypes, no values, no allocation.  This is the dry run's data
pipeline."""
from __future__ import annotations

import torch

from ..models.config import InputShape, ModelConfig


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    B, S = shape.global_batch, shape.seq_len
    specs: dict = {"labels": _meta((B, S), torch.int32)}
    if cfg.embed_inputs:
        specs["tokens"] = _meta((B, S), torch.int32)
    else:
        specs["features"] = _meta((B, S, cfg.d_model), torch.bfloat16)
    if cfg.xattn_tokens:
        specs["vision"] = _meta((B, cfg.xattn_tokens, cfg.d_model),
                                torch.bfloat16)
    return specs


def prefill_input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    specs = train_input_specs(cfg, shape)
    specs.pop("labels")
    return specs


def decode_input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    B = shape.global_batch
    specs: dict = {}
    if not cfg.embed_inputs:
        specs["features"] = _meta((B, 1, cfg.d_model), torch.bfloat16)
    specs["token"] = _meta((B, 1), torch.int32)   # unused with features
    if cfg.xattn_tokens:
        specs["vision"] = _meta((B, cfg.xattn_tokens, cfg.d_model),
                                torch.bfloat16)
    return specs


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    if shape.mode == "train":
        return train_input_specs(cfg, shape)
    if shape.mode == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)
