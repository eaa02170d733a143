"""llama-3.2-vision-11b [vlm] — cross-attention image layers
[hf:meta-llama/Llama-3.2-11B-Vision]

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; every 5th layer
is gated cross-attention onto vision-patch embeddings.  The ViT/projector
frontend is stubbed: ``input_specs`` provides precomputed patch
embeddings (B, n_patches, d_model).
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14_336, vocab=128_256,
    pattern=("attn", "attn", "attn", "attn", "xattn"),
    xattn_tokens=1_600,          # 1 tile x 40x40 patches (stub frontend)
    rope_style="llama", rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)

SUPPORTED_SHAPES = ["train_4k", "prefill_32k", "decode_32k"]   # full attn -> no 500k


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-smoke", n_layers=5, d_model=256,
        n_heads=8, n_kv_heads=2, d_ff=512, vocab=512, xattn_tokens=16,
        remat=False)
