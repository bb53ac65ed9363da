"""Architecture registry: full assigned configs + reduced smoke variants."""

from __future__ import annotations

from .base import (
    EncDecConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    VLMConfig,
)
from . import (
    arctic_480b,
    deepseek_coder_33b,
    deepseek_v3_671b,
    internlm2_20b,
    internvl2_26b,
    jamba_v0_1_52b,
    qwen1_5_32b,
    qwen3_1_7b,
    rwkv6_3b,
    whisper_base,
)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        qwen1_5_32b,
        deepseek_coder_33b,
        qwen3_1_7b,
        internlm2_20b,
        arctic_480b,
        deepseek_v3_671b,
        rwkv6_3b,
        jamba_v0_1_52b,
        internvl2_26b,
        whisper_base,
    )
}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: few layers, small
    width, tiny vocab/experts — preserves every structural feature."""
    cfg = get(name)
    kw: dict = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=16,
        d_ff=96,
        vocab_size=503,  # deliberately non-multiple of 256 → padding path
        vocab_padded=0,
        remat="none",
    )
    if cfg.moe:
        kw["moe"] = MoEConfig(
            n_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            expert_ff=32,
            shared_ff=32 if cfg.moe.shared_ff else 0,
            dense_residual_ff=32 if cfg.moe.dense_residual_ff else 0,
            layer_period=cfg.moe.layer_period,
            layer_offset=cfg.moe.layer_offset,
            first_dense=min(cfg.moe.first_dense, 1),
            dense_ff=96 if cfg.moe.dense_ff else 0,
            router_softmax_topk=cfg.moe.router_softmax_topk,
            norm_topk_prob=cfg.moe.norm_topk_prob,
        )
    if cfg.mla:
        kw["mla"] = MLAConfig(
            q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16,
        )
        kw["head_dim"] = 16
    if cfg.ssm:
        kw["ssm"] = SSMConfig(
            kind=cfg.ssm.kind,
            d_state=8,
            d_conv=cfg.ssm.d_conv,
            expand=cfg.ssm.expand,
            attn_layer_period=4 if cfg.ssm.attn_layer_period else 0,
            attn_layer_offset=min(cfg.ssm.attn_layer_offset, 3),
        )
        if cfg.ssm.kind == "rwkv6":
            kw["n_heads"] = 4
            kw["d_model"] = 64  # head_dim 16
        if cfg.ssm.attn_layer_period:
            kw["n_layers"] = 4  # one full jamba period
            if cfg.moe:
                kw["moe"] = kw["moe"].__class__(
                    **{**kw["moe"].__dict__, "layer_period": 2, "layer_offset": 1}
                )
    if cfg.encdec:
        kw["encdec"] = EncDecConfig(n_enc_layers=2, n_frames=8)
    if cfg.vlm:
        kw["vlm"] = VLMConfig(n_patches=4)
    if cfg.mtp:
        kw["mtp"] = True
    return cfg.replace(name=f"{cfg.name}-smoke", **kw)


def all_arch_names() -> list[str]:
    return list(ARCHS)
