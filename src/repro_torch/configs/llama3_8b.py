"""llama3-8b [dense] — GQA, 128k vocab [arXiv:2407.21783]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14_336, vocab=128_256,
    pattern=("attn",),
    rope_style="llama", rope_theta=500_000.0,
    source="arXiv:2407.21783",
)

SUPPORTED_SHAPES = ["train_4k", "prefill_32k", "decode_32k"]   # full attn -> no 500k


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-smoke", n_layers=2, d_model=256,
        n_heads=8, n_kv_heads=2, d_ff=512, vocab=512, remat=False)
