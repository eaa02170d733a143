"""hubert-xlarge [audio] — encoder-only, same arch as wav2vec2
[arXiv:2106.07447]

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (masked-unit targets).
The conv/mel frontend is stubbed: ``input_specs`` provides precomputed
frame embeddings (B, S, d_model).
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5_120, vocab=504,
    pattern=("attn",),
    rope_style="none",          # hubert uses conv positional embeddings
                                # (part of the stubbed frontend)
    causal=False,               # bidirectional encoder
    embed_inputs=False,         # consumes frame embeddings directly
    source="arXiv:2106.07447",
    notes="encoder-only: decode_32k / long_500k have no decode step (SKIP)",
)

SUPPORTED_SHAPES = ["train_4k", "prefill_32k"]   # no decode step exists


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-smoke", n_layers=2, d_model=256,
        n_heads=8, n_kv_heads=8, d_ff=512, vocab=64, remat=False)
