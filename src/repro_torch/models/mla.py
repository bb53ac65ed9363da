"""Multi-head Latent Attention (DeepSeek-V2/V3) with a compressed KV cache.

A port of the reference package's ``models/mla.py``. Train and prefill
decompress the latent ``c_kv`` to full K/V and run the chunked attention of
``layers``. Decode takes the ABSORBED form: ``q_nope`` is folded through
``W_uk`` so that scores are taken against the cached latent (plus the
shared rope key) in float32, and the output is rebuilt through ``W_uv``.
The cache holds only ``c_kv`` (``kv_lora_rank``) and ``k_rope``
(``qk_rope_head_dim``) a token, and decode writes it in place.

Leaf names and layouts are the reference's (``w_uk`` is (r, H·d_nope), and
so on), so ``convert.params_from_reference`` carries weights across as they
are.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import (
    NO_CTX,
    _scatter_time,
    apply_rope,
    chunked_causal_attention,
    init_device,
    rmsnorm,
    rmsnorm_init,
    rope_angles,
    truncnorm_init,
)


def mla_init(generator, cfg, dtype=torch.bfloat16):
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    dev = init_device(generator)
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": truncnorm_init(generator, (d, m.q_lora_rank), dtype),
        "q_norm": rmsnorm_init(m.q_lora_rank, dtype, dev),
        "w_uq": truncnorm_init(generator, (m.q_lora_rank, H * qk_head), dtype),
        "w_dkv": truncnorm_init(generator, (d, m.kv_lora_rank), dtype),
        "kv_norm": rmsnorm_init(m.kv_lora_rank, dtype, dev),
        "w_uk": truncnorm_init(generator, (m.kv_lora_rank, H * m.qk_nope_head_dim), dtype),
        "w_uv": truncnorm_init(generator, (m.kv_lora_rank, H * m.v_head_dim), dtype),
        "w_kr": truncnorm_init(generator, (d, m.qk_rope_head_dim), dtype),  # one head, shared
        "wo": truncnorm_init(generator, (H * m.v_head_dim, d), dtype),
    }


def mla_specs(cfg):
    return {
        "w_dq": ("d_model", None),
        "q_norm": {"scale": (None,)},
        "w_uq": (None, "heads"),
        "w_dkv": ("d_model", None),
        "kv_norm": {"scale": (None,)},
        "w_uk": (None, "heads"),
        "w_uv": (None, "heads"),
        "w_kr": ("d_model", None),
        "wo": ("heads", "d_model"),
    }


def _mla_qkr(params, x, cfg, positions):
    """The shared query and rope pieces: q_nope (B,S,H,dn), q_rope
    (B,S,H,dr), c_kv (B,S,r), k_rope (B,S,1,dr)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q = rmsnorm(params["q_norm"], x @ params["w_dq"]) @ params["w_uq"]
    q = q.reshape(B, S, H, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    c_kv = rmsnorm(params["kv_norm"], x @ params["w_dkv"])
    k_rope = (x @ params["w_kr"]).reshape(B, S, 1, m.qk_rope_head_dim)
    cos, sin = rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return q_nope, apply_rope(q_rope, cos, sin), c_kv, apply_rope(k_rope, cos, sin)


def mla_fwd(params, x, cfg, ctx=NO_CTX, positions=None):
    """Full sequence (train, prefill). Returns (y, (c_kv (B,S,r), k_rope
    (B,S,dr))), the rows a decode cache holds."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q_nope, q_rope, c_kv, k_rope = _mla_qkr(params, x, cfg, positions)
    k_nope = (c_kv @ params["w_uk"]).reshape(B, S, H, m.qk_nope_head_dim)
    v = (c_kv @ params["w_uv"]).reshape(B, S, H, m.v_head_dim)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(B, S, H, m.qk_rope_head_dim)], dim=-1)
    # v padded to the q/k head width for the shared chunked attention, then cut
    v = F.pad(v, (0, q_full.shape[-1] - m.v_head_dim))
    o = chunked_causal_attention(q_full.transpose(1, 2), k_full.transpose(1, 2), v.transpose(1, 2))
    o = o.transpose(1, 2)[..., : m.v_head_dim].reshape(B, S, -1)
    y = o @ params["wo"]
    return ctx.cons(y, ("batch", "seq", "d_model")), (c_kv, k_rope[:, :, 0, :])


def mla_decode(params, x, cfg, cache, pos, ctx=NO_CTX):
    """Absorbed decode. x: (B,1,d); cache: {"c_kv": (B,Smax,r), "k_rope":
    (B,Smax,dr)}; pos: (B,) int. Writes this step's latent and rope key at
    ``pos`` in place and returns (y, cache)."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkr(params, x, cfg, pos[:, None])
    ckv = _scatter_time(cache["c_kv"], c_kv_new, pos)
    krp = _scatter_time(cache["k_rope"], k_rope_new[:, :, 0, :], pos)
    Smax = ckv.shape[1]
    # absorb: q_lat[h] = q_nope[h] @ W_uk[h]^T scores against the latent itself
    w_uk = params["w_uk"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)  # (B,H,r), in the model's dtype
    ckv_f = ckv.float()
    s = torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv_f) + torch.einsum(
        "bhd,bsd->bhs", q_rope[:, 0].float(), krp.float())
    s = s / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    mask = torch.arange(Smax, device=x.device)[None, :] <= pos[:, None]
    s = s.masked_fill(~mask[:, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", p, ckv_f)  # (B,H,r)
    w_uv = params["w_uv"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    o = torch.einsum("bhr,rhd->bhd", o_lat, w_uv.float()).to(x.dtype)
    y = o.reshape(B, 1, -1) @ params["wo"]
    return y, cache


def mla_cache_init(cfg, batch, s_max, dtype=torch.bfloat16, device=None, layers: int | None = None):
    """Zeros: {"c_kv": (batch, s_max, r), "k_rope": (batch, s_max, dr)},
    with a leading ``layers`` axis when it is given (a stacked body)."""
    m = cfg.mla
    lead = () if layers is None else (layers,)
    return {
        "c_kv": torch.zeros((*lead, batch, s_max, m.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((*lead, batch, s_max, m.qk_rope_head_dim), dtype=dtype, device=device),
    }


def mla_cache_dims():
    return {"c_kv": ("batch", "kv_seq", None), "k_rope": ("batch", "kv_seq", None)}
