"""Snowflake Arctic 480B: dense-MoE hybrid — every layer has a dense
residual FFN in parallel with a 128-expert top-2 MoE
[hf:Snowflake/snowflake-arctic-base; hf]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    rope_theta=1e6,
    moe=MoEConfig(
        n_experts=128,
        top_k=2,
        expert_ff=4864,
        dense_residual_ff=4864,
        router_softmax_topk=True,
    ),
    source="hf:Snowflake/snowflake-arctic-base (35L d7168 56H kv8 ff4864 v32000, 128e top-2 + dense residual)",
)
