"""Architecture configuration for the model families, the port's copy of
the JAX package's ``models/config.py`` (pure data, so that names agree).

One :class:`ModelConfig` describes any of the 6 arch types (dense, moe,
ssm, hybrid, audio-encoder, vlm) via a repeating ``pattern`` of block types
('attn', 'xattn', 'mlstm', 'slstm', 'mamba') and FFN/MoE settings.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                       # 0 -> d_model // n_heads
    pattern: tuple[str, ...] = ("attn",)    # block types, cycled over layers
    # --- attention ---
    rope_style: str = "llama"               # "llama" | "partial" | "none"
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0              # "partial": fraction of head_dim rotated (chatglm RoPE-2d)
    qkv_bias: bool = False
    sliding_window: int | None = None
    causal: bool = True                     # False => encoder-only (hubert)
    # --- cross attention (VLM) ---
    xattn_tokens: int = 0                   # vision/frontend token count
    # --- embeddings / IO ---
    embed_inputs: bool = True               # False => model consumes frame
                                            # embeddings directly (audio stub)
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1                      # MoE on every k-th FFN
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM ---
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    mlstm_chunk: int = 256
    # --- numerics / training ---
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True
    use_flash_kernel: bool = False   # route attention through the Pallas
                                     # flash kernel (TPU; interpret on CPU).
                                     # Differentiable: custom VJP backed by
                                     # flash backward kernels (dq / dkv).
    # --- provenance ---
    source: str = ""                        # citation of the published config
    notes: str = ""

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_rep(self) -> int:
        """Number of pattern repetitions (= scan length over the stack)."""
        assert self.n_layers % len(self.pattern) == 0, \
            f"{self.name}: n_layers {self.n_layers} % pattern {len(self.pattern)}"
        return self.n_layers // len(self.pattern)

    def block_kinds(self) -> tuple[str, ...]:
        return self.pattern

    def ffn_is_moe(self, pattern_pos: int, rep: int | None = None) -> bool:
        """Whether the FFN at this pattern position is MoE.  ``moe_every``
        is applied over pattern positions so the scanned stack stays
        homogeneous across repetitions."""
        if self.n_experts == 0:
            return False
        return (pattern_pos % self.moe_every) == (self.moe_every - 1)

    # ---- analytics ----------------------------------------------------
    def param_count(self) -> float:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        D, F, V, hd = self.d_model, self.d_ff, self.vocab, self.hd
        total = V * D * (1 if self.tie_embeddings else 2) if self.embed_inputs \
            else V * D + D * D
        per_pattern = 0.0
        for pos, kind in enumerate(self.pattern):
            if kind in ("attn", "xattn"):
                per_pattern += D * (self.n_heads * hd) + 2 * D * (self.n_kv_heads * hd) \
                    + (self.n_heads * hd) * D
            elif kind == "mlstm":
                di = D * self.ssm_expand
                per_pattern += 3 * D * di + 3 * D * self.n_heads + di * D
            elif kind == "slstm":
                per_pattern += 4 * D * D + 4 * self.hd * self.hd * self.n_heads
            elif kind == "mamba":
                di = D * self.ssm_expand
                per_pattern += 2 * D * di + di * (2 * self.ssm_state + 2) \
                    + di * self.ssm_state + di * D
            if F > 0:       # every block carries an FFN when d_ff > 0
                if self.ffn_is_moe(pos):
                    per_pattern += self.n_experts * 3 * D * F + D * self.n_experts
                else:
                    per_pattern += 3 * D * F
        return total + per_pattern * self.n_rep

    def active_param_count(self) -> float:
        """Active params per token (MoE counts top_k experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        dead_per_pattern = 0.0
        for pos, _ in enumerate(self.pattern):
            if F > 0 and self.ffn_is_moe(pos):
                dead_per_pattern += (self.n_experts - self.top_k) * 3 * D * F
        return self.param_count() - dead_per_pattern * self.n_rep


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                 # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",  524_288,    1, "decode"),
}
