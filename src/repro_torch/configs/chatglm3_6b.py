"""chatglm3-6b [dense] — RoPE-2d (partial rotary), extreme GQA
[arXiv:2406.12793]

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024, QKV bias,
half-dim rotary (ChatGLM applies RoPE to half of each head dim).
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13_696, vocab=65_024,
    pattern=("attn",),
    rope_style="partial", rope_fraction=0.5, rope_theta=10_000.0,
    qkv_bias=True,
    source="arXiv:2406.12793",
)

SUPPORTED_SHAPES = ["train_4k", "prefill_32k", "decode_32k"]   # full attn -> no 500k


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-smoke", n_layers=2, d_model=256,
        n_heads=8, n_kv_heads=2, d_ff=512, vocab=512, remat=False)
