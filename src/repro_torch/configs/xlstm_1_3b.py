"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517]

48L d_model=2048 4H (kv=4) d_ff=0 vocab=50304; alternating mLSTM/sLSTM
blocks (standalone, no FFN: d_ff=0).
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50_304,
    pattern=("mlstm", "slstm"),
    rope_style="none",
    ssm_expand=2, mlstm_chunk=256,
    source="arXiv:2405.04517",
    notes="recurrent O(1) decode state -> long_500k supported",
)

SUPPORTED_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-smoke", n_layers=2, d_model=256,
        n_heads=4, n_kv_heads=4, vocab=512, mlstm_chunk=32, remat=False)
