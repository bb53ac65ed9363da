"""Whisper-base: encoder-decoder, conv frontend STUB (precomputed frame
embeddings via input_specs) [arXiv:2212.04356]."""
from .base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,  # decoder layers; encoder layers in encdec
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,  # padded to 51968
    encdec=EncDecConfig(n_enc_layers=6, n_frames=1500),
    source="arXiv:2212.04356 (6L enc + 6L dec, d512 8H ff2048 v51865)",
)
