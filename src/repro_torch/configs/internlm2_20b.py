"""InternLM2-20B: dense GQA [arXiv:2403.17297; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    rope_theta=1e6,
    source="arXiv:2403.17297 (48L d6144 48H kv8 ff16384 v92544)",
)
