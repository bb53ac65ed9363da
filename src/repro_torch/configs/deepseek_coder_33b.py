"""DeepSeek-Coder-33B: llama-arch dense GQA [arXiv:2401.14196; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=1e5,
    source="arXiv:2401.14196 (62L d7168 56H kv8 ff19200 v32256)",
)
