"""Qwen1.5-32B: dense, QKV bias, large vocab [hf:Qwen/Qwen1.5-32B; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-32B (per-assignment: 64L d5120 40H kv40 ff27392 v152064)",
)
