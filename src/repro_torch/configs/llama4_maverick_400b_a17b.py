"""llama4-maverick-400b-a17b [moe] — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E]

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
Interleaved dense/MoE FFN (every other layer MoE) to land at ~400B total /
~17B active, matching the model card.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202_048,
    pattern=("attn", "attn"),          # pos1 carries the MoE FFN
    n_experts=128, top_k=1, moe_every=2,
    rope_style="llama", rope_theta=500_000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    notes="full (quadratic) attention; long_500k skipped (chunked-attention "
          "variant not part of the spec)",
)

# long_500k skipped: pure full-attention decoder (DESIGN.md §5).
SUPPORTED_SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-smoke", n_layers=2, d_model=256,
        n_heads=8, n_kv_heads=2, d_ff=512, vocab=512, n_experts=4, top_k=1,
        remat=False)
