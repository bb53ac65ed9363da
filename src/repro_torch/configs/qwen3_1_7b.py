"""Qwen3-1.7B: dense GQA with qk_norm [hf:Qwen/Qwen3-1.7B; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-1.7B (28L d2048 16H kv8 ff6144 v151936, qk_norm)",
)
