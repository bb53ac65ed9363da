"""InternVL2-26B: InternViT-6B frontend (STUB: precomputed patch embeddings)
+ InternLM2-20B backbone [arXiv:2404.16821; hf]."""
from .base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,  # padded to 92672 (vocab_padded auto)
    rope_theta=1e6,
    vlm=VLMConfig(n_patches=256),
    source="arXiv:2404.16821 (InternViT stub + InternLM2-20B: 48L d6144 48H kv8 ff16384 v92553)",
)
