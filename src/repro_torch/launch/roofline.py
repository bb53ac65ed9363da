"""Analytic parameter counts from a model's configuration: the part of the
reference's ``launch/roofline.py`` that is pure arithmetic.

:func:`param_counts` gives a configuration's total and per-token active
parameters; ``launch.profiles`` reads it to decide whether a model's state
fits without FSDP. The roofline table itself (the compiled program's flops,
bytes and collective bytes against a device's peaks) reads the JAX
compiler's cost analysis and waits for ROADMAP.md queue A5.
"""

from __future__ import annotations


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

