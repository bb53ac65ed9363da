"""Per-shape sharding-rule presets, as the reference's ``launch/rules.py``
sets them (DESIGN §6 there).

train / prefill:
    batch → (pod, data);  seq → model (Megatron-style sequence sharding of
    activations at block boundaries — GSPMD inserts the gather/scatter
    around attention);  params FSDP-sharded: feature dims → model, d_model →
    data (ZeRO-3 semantics via GSPMD all-gathers).
decode:
    batch → (pod, data);  KV-cache sequence → model (flash-decoding-style
    split-KV — works for every arch incl. kv_heads < mesh axis);
    long_500k (batch=1): KV seq → (data, model) — all 256/512 chips split
    the half-million-token cache.

The axes take effect on a mesh of ranks, where arrays are DTensors placed by
them (``dist.sharding``); on one device the rules' flags are what the model
reads.
"""

from __future__ import annotations

from ..configs.base import ModelConfig, ShapeSpec
from ..dist.sharding import ShardingRules


def rules_for(cfg: ModelConfig, shape: ShapeSpec) -> ShardingRules:
    r = ShardingRules().override(seq=("model",), d_model=("data",))
    if shape.kind == "decode":
        kv = ("data", "model") if shape.global_batch == 1 else ("model",)
        r = r.override(seq=(), kv_seq=kv, kv_heads=())
    return r


def big_model(cfg: ModelConfig) -> bool:
    """>100B params → bf16 optimizer moments (EXPERIMENTS §Dry-run notes)."""
    return cfg.name.split("-")[-1] in ("480b", "671b") or cfg.family == "moe"
