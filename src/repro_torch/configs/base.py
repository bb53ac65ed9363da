"""Config dataclasses for architectures and input shapes."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_ff: int
    shared_ff: int = 0  # width of always-on shared expert(s); 0 = none
    dense_residual_ff: int = 0  # Arctic: dense FFN in parallel with the MoE
    layer_period: int = 1  # MoE every `period` layers ...
    layer_offset: int = 0  # ... starting at `offset`
    first_dense: int = 0  # leading dense layers (DeepSeek-V3: 3)
    dense_ff: int = 0  # d_ff of the dense layers when first_dense > 0
    capacity_factor: float = 1.25
    router_softmax_topk: bool = True  # False → topk-then-softmax (DeepSeek)
    norm_topk_prob: bool = False


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba"  # "mamba" | "rwkv6"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None
    attn_layer_period: int = 0  # Jamba: attention every `period` layers
    attn_layer_offset: int = 0


@dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int = 6
    n_frames: int = 1500  # precomputed frame-embedding stub length


@dataclass(frozen=True)
class VLMConfig:
    n_patches: int = 256  # precomputed patch-embedding stub length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    vocab_padded: int = 0  # 0 → auto-pad to multiple of 256
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    encdec: EncDecConfig | None = None
    vlm: VLMConfig | None = None
    mtp: bool = False  # DeepSeek-V3 multi-token-prediction module
    dtype: str = "bfloat16"
    remat: str = "block"  # "none" | "block" — activation checkpoint per layer
    time_chunk: int = 0  # >0: chunk+checkpoint SSM/RWKV time scans (§Perf lever)
    source: str = ""  # public provenance tag

    def __post_init__(self):
        if self.vocab_padded == 0:
            object.__setattr__(
                self, "vocab_padded", ((self.vocab_size + 255) // 256) * 256
            )
        assert self.vocab_padded >= self.vocab_size

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch has an O(1)-state decode path (long_500k eligible)."""
        return self.ssm is not None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) per the assignment's skip rules."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "long_500k needs a sub-quadratic state path; "
            f"{cfg.name} is a pure full-attention architecture (skip per brief)"
        )
    return True, ""
