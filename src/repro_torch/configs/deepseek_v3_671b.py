"""DeepSeek-V3 671B: MLA + 256-expert top-8 MoE (1 shared), 3 leading dense
layers, MTP [arXiv:2412.19437; hf]."""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=2048,  # routed-expert width (assignment's d_ff)
    vocab_size=129280,
    rope_theta=1e4,
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        expert_ff=2048,
        shared_ff=2048,  # 1 shared expert
        first_dense=3,
        dense_ff=18432,
        router_softmax_topk=False,  # sigmoid/topk-then-norm style routing
        norm_topk_prob=True,
    ),
    mtp=True,
    source="arXiv:2412.19437 (61L d7168 128H MLA, 256e top-8 + 1 shared, MTP)",
)
