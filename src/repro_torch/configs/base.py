"""Architecture configuration schema for the assigned model pool.

The port of `repro.configs.base`: the same frozen dataclass, field for
field, so a config compares equal to the reference's by its fields.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # per-layer pattern, cycled: entries are "global" | "local" | "mamba"
    layer_pattern: tuple[str, ...] = ("global",)
    window: int = 0                # sliding-window size for "local" layers
    qk_norm: bool = False
    rope_theta: float = 1e4
    mrope_sections: tuple[int, ...] = ()   # qwen2-vl M-RoPE (t,h,w) split
    causal: bool = True            # False => encoder-only (no decode shapes)
    tie_embeddings: bool = True
    act: str = "silu"              # mlp nonlinearity ("silu" -> swiglu)
    norm_eps: float = 1e-6
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_period: int = 1            # every k-th layer is MoE (jamba: 2)
    capacity_factor: float = 1.25
    # Mamba2 (SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    # modality frontend stub: "none" | "audio" | "vision"
    frontend: str = "none"
    # training
    optimizer: str = "adamw"       # "adafactor" for the 398B/1T archs
    remat: bool = True
    dtype: str = "bfloat16"
    # perf knobs: sequence-parallel attention for head counts that don't
    # divide the model axis; grad-reduction dtype
    seq_parallel_attn: bool = False
    grad_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    @property
    def pattern_period(self) -> int:
        """Smallest period after which (mixer kind, is_moe) repeats."""
        import math
        p = len(self.layer_pattern)
        if self.n_experts:
            p = math.lcm(p, self.moe_period)
        return min(p, self.n_layers)

    def layer_kind(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def is_moe_layer(self, i: int) -> bool:
        """Every moe_period-th FFN is MoE. Jamba places MoE after BOTH
        attention and mamba mixers, so mamba layers are NOT excluded."""
        if self.n_experts == 0:
            return False
        return (i % self.moe_period) == (self.moe_period - 1)

    @property
    def d_inner(self) -> int:      # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return all(k == "mamba" for k in self.layer_pattern)

    @property
    def max_kv_seq_bounded(self) -> bool:
        """True if every attention layer has a bounded (windowed) KV cache."""
        kinds = set(self.layer_pattern)
        return "global" not in kinds

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic-ish archs run long_500k (brief's rule): SSM, hybrid,
        and SWA-dominant archs; pure full-attention archs skip it."""
        if self.family in ("ssm", "hybrid"):
            return True
        return "local" in self.layer_pattern

    @property
    def supports_decode(self) -> bool:
        return self.causal


# Each architecture is paired with these four shapes (brief):
SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def shape_applicable(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) per the brief's skip rules."""
    s = SHAPES[shape_name]
    if s["kind"] == "decode" and not cfg.supports_decode:
        return False, "encoder-only architecture: no decode step"
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention architecture: long_500k skipped"
    return True, ""
