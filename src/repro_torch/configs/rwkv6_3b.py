"""RWKV-6 (Finch) 3B: attention-free, data-dependent decay WKV
[arXiv:2404.05892; hf]."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,  # head_dim 64 (RWKV convention d/64)
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    ssm=SSMConfig(kind="rwkv6"),
    source="arXiv:2404.05892 (32L d2560 attn-free ff8960 v65536)",
)
