"""qwen2.5-32b [dense] — GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B]

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27_648, vocab=152_064,
    pattern=("attn",),
    rope_style="llama", rope_theta=1_000_000.0,
    qkv_bias=True,
    source="hf:Qwen/Qwen2.5-0.5B",
)

SUPPORTED_SHAPES = ["train_4k", "prefill_32k", "decode_32k"]   # full attn -> no 500k


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-smoke", n_layers=2, d_model=256,
        n_heads=8, n_kv_heads=2, d_ff=512, vocab=512, remat=False)
