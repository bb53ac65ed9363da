"""Jamba-v0.1 52B: Mamba+attention 1:7 interleave, 16-expert top-2 MoE on
alternate layers [arXiv:2403.19887; hf]."""
from .base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    moe=MoEConfig(
        n_experts=16,
        top_k=2,
        expert_ff=14336,
        layer_period=2,
        layer_offset=1,
    ),
    ssm=SSMConfig(
        kind="mamba",
        d_state=16,
        d_conv=4,
        expand=2,
        attn_layer_period=8,
        attn_layer_offset=4,
    ),
    source="arXiv:2403.19887 (32L d4096 32H kv8 ff14336 v65536, attn 1:7, 16e top-2)",
)
