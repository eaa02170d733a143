"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE
[arXiv:2403.19887]

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2 on
every other layer.  Pattern period 8 = one attention layer per 7 Mamba
layers, MoE FFN on odd positions (4 of 8), matching Jamba's layout.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24_576, vocab=65_536,
    pattern=("mamba", "mamba", "mamba", "attn",
             "mamba", "mamba", "mamba", "mamba"),
    n_experts=16, top_k=2, moe_every=2,
    rope_style="none",          # Jamba uses no positional encoding
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    source="arXiv:2403.19887",
    notes="O(1) Mamba state + 9 attn layers with bounded KV -> long_500k ok",
)

SUPPORTED_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-smoke", n_layers=8, d_model=256,
        n_heads=8, n_kv_heads=2, d_ff=512, vocab=512, n_experts=4, top_k=2,
        remat=False)
