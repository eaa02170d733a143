"""smollm-135m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M]

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152, tied embeddings.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    d_ff=1_536, vocab=49_152,
    pattern=("attn",),
    rope_style="llama", rope_theta=10_000.0,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)

SUPPORTED_SHAPES = ["train_4k", "prefill_32k", "decode_32k"]   # full attn -> no 500k


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-smoke", n_layers=2, d_model=288,
        n_heads=9, n_kv_heads=3, d_ff=512, vocab=512, remat=False)
