"""Roofline analysis of the port's dry-run records, against one NVIDIA H100.

Per (arch × shape × mesh) cell, the three roofline terms from the op-level
count of the step (``launch.op_cost``, recorded by ``launch.dryrun``):

    compute    = flops_per_device            / PEAK_FLOPS              [s]
    memory     = bytes_per_device (flash)    / HBM_BW                  [s]
    collective = collective_bytes_per_device / (P_LINKS × NVLINK_BW)  [s]

The peaks are the H100 SXM data sheet's dense rates at its 700 W power
limit, not measured: a card set below 700 W reaches less; NVLINK_BW is the
data sheet's NVLink rate, not measured either (the port has run on one card
only). The collective bytes are those the dry run counts on a production
mesh of ranks (``dist.counting`` over ``meta`` tensors): the differential
pass's ``collective_bytes_per_device_corrected`` where ``launch.costpass``
wrote it, else the dry run's own count (the layer body once), as the
reference reads them; a one-card record has none, so its term is 0.

MODEL_FLOPS (analytic useful flops, the reference's formulas):
    train : 6 · N_active · tokens   (+ attention term 12·L·d_head·H·S²·B·(…))
    prefill: 2 · N_active · tokens  (+ attention)
    decode : 2 · N_active · B  + 4·L·H·d_head·S_kv·B  (score+value reads)

The ratio MODEL_FLOPS / counted flops measures how much of the counted
compute is useful (catches remat recompute, dense-MoE waste, padding waste).

:func:`param_counts` also feeds ``launch.profiles`` (whether a model's
state fits without FSDP).
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W power limit;
# not measured here
PEAK_FLOPS = 989e12  # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12  # B/s
NVLINK_BW = 450e9  # B/s each way (NVLink 4, 18 links)
P_LINKS = 1


# ---------------------------------------------------------------------------
# analytic parameter/flop counts per architecture
# ---------------------------------------------------------------------------


def param_counts(cfg) -> dict:
    """(total, active) parameter counts from the config (embeddings included
    once; active = per-token touched params for MoE)."""
    d, L = cfg.d_model, cfg.n_layers
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    emb = cfg.vocab_padded * d * (1 if cfg.tie_embeddings else 2)

    def attn_params():
        if cfg.mla:
            m = cfg.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            return (
                d * m.q_lora_rank
                + m.q_lora_rank * H * qk
                + d * m.kv_lora_rank
                + m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                + d * m.qk_rope_head_dim
                + H * m.v_head_dim * d
            )
        return d * (H + 2 * Hkv) * hd + H * hd * d

    def mlp_params(ff):
        return 3 * d * ff

    total = emb
    active = emb
    prefix_dense = cfg.moe.first_dense if cfg.moe else 0
    for i in range(L):
        if cfg.ssm and cfg.ssm.kind == "rwkv6":
            tm = 5 * d * d + d * (5 * 32 + 5 * 32) + d * 64 * 2  # proj + loras
            cm = 2 * d * cfg.d_ff
            total += tm + cm
            active += tm + cm
            continue
        is_attn_layer = True
        if cfg.ssm and cfg.ssm.kind == "mamba":
            period = cfg.ssm.attn_layer_period or 8
            is_attn_layer = (i % period) == cfg.ssm.attn_layer_offset
        mix = attn_params() if is_attn_layer else _mamba_params(cfg)
        total += mix
        active += mix
        if cfg.moe and i >= prefix_dense and (i % cfg.moe.layer_period) == cfg.moe.layer_offset % cfg.moe.layer_period:
            e = cfg.moe
            total += e.n_experts * 3 * d * e.expert_ff + d * e.n_experts
            active += e.top_k * 3 * d * e.expert_ff + d * e.n_experts
            if e.shared_ff:
                total += 3 * d * e.shared_ff
                active += 3 * d * e.shared_ff
            if e.dense_residual_ff:
                total += 3 * d * e.dense_residual_ff
                active += 3 * d * e.dense_residual_ff
        elif cfg.moe and i < prefix_dense:
            total += mlp_params(cfg.moe.dense_ff or cfg.d_ff)
            active += mlp_params(cfg.moe.dense_ff or cfg.d_ff)
        else:
            total += mlp_params(cfg.d_ff)
            active += mlp_params(cfg.d_ff)
    if cfg.encdec:
        for _ in range(cfg.encdec.n_enc_layers):
            total += attn_params() + 2 * d * cfg.d_ff
            active += attn_params() + 2 * d * cfg.d_ff
        total += L * attn_params()  # cross attention
        active += L * attn_params()
    return {"total": int(total), "active": int(active)}


def _mamba_params(cfg):
    d = cfg.d_model
    din = cfg.ssm.expand * d
    dtr = max(1, -(-d // 16))
    return d * 2 * din + cfg.ssm.d_conv * din + din * (dtr + 2 * cfg.ssm.d_state) + dtr * din + din * d


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs per step (global, not per device)."""
    pc = param_counts(cfg)
    N_act = pc["active"]
    B, S = shape.global_batch, shape.seq_len
    d_attn = cfg.head_dim * cfg.n_heads
    L_attn = cfg.n_layers
    if cfg.ssm and cfg.ssm.kind == "mamba":
        period = cfg.ssm.attn_layer_period or 8
        L_attn = cfg.n_layers // period
    elif cfg.ssm and cfg.ssm.kind == "rwkv6":
        L_attn = 0
    if shape.kind == "train":
        tokens = B * S
        flops = 6.0 * N_act * tokens
        # causal attention: 2(fwd)+4(bwd... included in 3x rule) — add QK^T+PV
        flops += 3 * 2 * 2 * L_attn * d_attn * (S * S / 2) * B
        return flops
    if shape.kind == "prefill":
        tokens = B * S
        return 2.0 * N_act * tokens + 2 * 2 * L_attn * d_attn * (S * S / 2) * B
    # decode: one token; KV reads
    kv_dim = (
        (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim)
        if cfg.mla
        else 2 * cfg.n_kv_heads * cfg.head_dim
    )
    return 2.0 * N_act * B + 2 * L_attn * (d_attn + kv_dim) * S * B


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    status: str
    compute_s: float = float("nan")
    memory_s: float = float("nan")
    collective_s: float = float("nan")
    bottleneck: str = ""
    model_flops: float = float("nan")
    hlo_flops_global: float = float("nan")  # the counted flops (the reference's name kept)
    useful_ratio: float = float("nan")
    hbm_gb_per_dev: float = float("nan")
    note: str = ""


def analyze(rec: dict) -> RooflineRow:
    """One record of ``launch.dryrun`` → its roofline row. The memory term
    uses the flash-fused byte count (attention score tiles stay on chip in a
    fused kernel, ``op_cost.Cost.tile_bytes``); the footprint is the live-bytes
    tracker's argument + temp + output bytes."""
    from ..configs import SHAPES, get

    row = RooflineRow(rec["arch"], rec["shape"], rec["mesh"], rec.get("status", "?"))
    if rec.get("status") != "ok":
        row.note = rec.get("reason", rec.get("error", ""))[:120]
        return row
    n = rec["n_chips"]
    oc = rec["op_cost"]
    fl = oc["flops_global"] / n
    by = (oc["bytes_global"] - oc.get("tile_bytes_global", 0.0)) / n
    row.note = "op-cost+flash" + (f" ({oc['method']})" if oc.get("method") else "")
    cb = rec.get("collective_bytes_per_device_corrected", rec.get("collective_bytes_per_device", 0))
    row.compute_s = fl / PEAK_FLOPS
    row.memory_s = by / HBM_BW
    row.collective_s = cb / (P_LINKS * NVLINK_BW)
    terms = {
        "compute": row.compute_s,
        "memory": row.memory_s,
        "collective": row.collective_s,
    }
    row.bottleneck = max(terms, key=terms.get)
    cfg = get(rec["arch"])
    shape = SHAPES[rec["shape"]]
    row.model_flops = model_flops(cfg, shape)
    row.hlo_flops_global = fl * n
    row.useful_ratio = row.model_flops / row.hlo_flops_global if fl > 0 else float("nan")
    m = rec["memory"]
    row.hbm_gb_per_dev = (m["argument_bytes"] + m["temp_bytes"] + m["output_bytes"]) / 1e9
    return row


def load_all(out_dir: str = "results/dryrun_torch") -> list[RooflineRow]:
    rows = []
    for p in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(p) as fh:
            rows.append(analyze(json.load(fh)))
    return rows


def render_table(rows: list[RooflineRow]) -> str:
    hdr = (
        f"{'arch':22s} {'shape':12s} {'mesh':11s} {'status':8s} "
        f"{'compute_s':>10s} {'memory_s':>10s} {'collect_s':>10s} {'bound':>10s} "
        f"{'useful':>7s} {'HBM_GB':>7s}  note"
    )
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:22s} {r.shape:12s} {r.mesh:11s} {r.status:8s} "
            f"{r.compute_s:10.3e} {r.memory_s:10.3e} {r.collective_s:10.3e} {r.bottleneck:>10s} "
            f"{r.useful_ratio:7.3f} {r.hbm_gb_per_dev:7.2f}  {r.note}"
        )
    return "\n".join(lines)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Roofline table of the port's dry-run records (H100 data-sheet peaks)")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--json", default=None, help="also dump rows as json")
    args = ap.parse_args(argv)
    rows = load_all(args.out)
    print(render_table(rows))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump([r.__dict__ for r in rows], fh, indent=2)


if __name__ == "__main__":
    main()
