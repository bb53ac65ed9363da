"""Model input construction: concrete batches for tests and the smoke run,
and ``meta`` tensor specs for the dry run (shapes and dtypes, no storage).

The batches are drawn with numpy from a seed, exactly as the reference
draws them, so both packages see the same tokens for the same seed.
Modality frontends are stubs as in the reference: the encoder-decoder gets
precomputed frame embeddings (B, n_frames, d_model), the VLM precomputed
patch embeddings (B, n_patches, d_model); for VLM shapes ``S`` counts the
total positions (patches + text)."""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..core.field import resolve_device


def batch_dims(cfg: ModelConfig, kind: str) -> dict:
    """Logical dim names for each batch field."""
    d: dict = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    if cfg.encdec is not None:
        d["frames"] = ("batch", "frames", "d_model")
    if cfg.vlm is not None:
        d["patches"] = ("batch", "seq", "d_model")
    if kind == "decode":
        d = {"tokens": ("batch", None), "pos": ("batch",)}
    return d


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec, dtype=torch.bfloat16) -> dict:
    """A train or prefill batch of ``shape`` as ``meta`` tensors."""
    B, S = shape.global_batch, shape.seq_len
    text_s = S - (cfg.vlm.n_patches if cfg.vlm else 0)
    spec: dict = {
        "tokens": torch.empty((B, text_s), dtype=torch.int32, device="meta"),
        "labels": torch.empty((B, text_s), dtype=torch.int32, device="meta"),
    }
    if cfg.encdec is not None:
        spec["frames"] = torch.empty((B, cfg.encdec.n_frames, cfg.d_model), dtype=dtype, device="meta")
    if cfg.vlm is not None:
        spec["patches"] = torch.empty((B, cfg.vlm.n_patches, cfg.d_model), dtype=dtype, device="meta")
    return spec


def decode_input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """One decode step's tokens (B, 1) and positions (B,) as ``meta`` tensors."""
    B = shape.global_batch
    return {
        "tokens": torch.empty((B, 1), dtype=torch.int32, device="meta"),
        "pos": torch.empty((B,), dtype=torch.int32, device="meta"),
    }


def make_batch(cfg: ModelConfig, B: int, S: int, seed: int = 0, device=None) -> dict:
    """A seeded batch of tensors on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    text_s = S - (cfg.vlm.n_patches if cfg.vlm else 0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, text_s), dtype=np.int32)).to(dev)
    batch = {"tokens": tokens, "labels": tokens.clone()}
    if cfg.encdec is not None:
        frames = rng.normal(size=(B, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32) * 0.02
        batch["frames"] = torch.from_numpy(frames).to(dev).to(torch.bfloat16)
    if cfg.vlm is not None:
        patches = rng.normal(size=(B, cfg.vlm.n_patches, cfg.d_model)).astype(np.float32) * 0.02
        batch["patches"] = torch.from_numpy(patches).to(dev).to(torch.bfloat16)
    return batch
