"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention
[arXiv:2401.04088]

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2,
every layer MoE, SWA window 4096.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16_384, vocab=32_768,
    pattern=("attn",),
    n_experts=8, top_k=2, moe_every=1,
    sliding_window=4_096,
    rope_style="llama", rope_theta=1_000_000.0,
    source="arXiv:2401.04088",
    notes="SWA makes decode KV a 4096 ring buffer -> long_500k supported",
)

# SWA -> sub-quadratic decode: long_500k runs with the windowed ring cache.
SUPPORTED_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-smoke", n_layers=2, d_model=256,
        n_heads=8, n_kv_heads=2, d_ff=512, vocab=512, n_experts=4, top_k=2,
        sliding_window=64, remat=False)
