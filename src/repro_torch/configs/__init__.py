"""Architecture registry, the port's copy of the JAX package's
``configs/``: one module per architecture, pure data, so that names and
widths agree with the reference; plus ``ctgan_paper``, the paper's own
CTGAN config.

``get_config(name)`` returns the full-size :class:`ModelConfig`;
``get_smoke_config(name)`` the reduced same-family variant of the CPU
tests (2 layers, d_model <= 512).  The port's
:class:`repro_torch.models.Transformer` runs every one of them.
"""
from __future__ import annotations

from ..models.config import INPUT_SHAPES, InputShape, ModelConfig  # noqa: F401
from . import (chatglm3_6b, hubert_xlarge, jamba_1_5_large_398b, llama3_8b,
               llama4_maverick_400b_a17b, llama_3_2_vision_11b, mixtral_8x22b,
               qwen2_5_32b, smollm_135m, xlstm_1_3b)

_MODULES = {
    "llama4-maverick-400b-a17b": llama4_maverick_400b_a17b,
    "mixtral-8x22b": mixtral_8x22b,
    "llama3-8b": llama3_8b,
    "smollm-135m": smollm_135m,
    "xlstm-1.3b": xlstm_1_3b,
    "hubert-xlarge": hubert_xlarge,
    "chatglm3-6b": chatglm3_6b,
    "qwen2.5-32b": qwen2_5_32b,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "llama-3.2-vision-11b": llama_3_2_vision_11b,
}

ARCH_NAMES = list(_MODULES)


def get_config(name: str) -> ModelConfig:
    return _MODULES[name].CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _MODULES[name].smoke_config()


def supported_shapes(name: str) -> list[str]:
    """Which of the 4 assigned input shapes run for this arch (an
    encoder-only arch has no decode shapes)."""
    return _MODULES[name].SUPPORTED_SHAPES
