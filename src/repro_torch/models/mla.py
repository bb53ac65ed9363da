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

On a mesh of ranks the full-sequence attention runs on each rank's blocks
(batch and heads split, the sequence whole) under the reference's head
constraints, and the absorbed decode writes and scores each rank's block of
the latent cache, split over ``kv_seq``'s axes, combining the softmax over
them; the absorbed products follow the heads' placement.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..dist._compat import shard_map
from ..dist.sharding import spec_for, spec_of
from .layers import (
    NO_CTX,
    _local_offsets,
    _meshed,
    _scatter_time,
    _write_rows,
    apply_rope,
    chunked_causal_attention,
    init_device,
    replicated_like,
    rmsnorm,
    rmsnorm_init,
    rope_angles,
    rows,
    softmax_weighted,
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
    x = rows(x)
    q = rows(rmsnorm(params["q_norm"], x @ params["w_dq"])) @ params["w_uq"]
    q = q.reshape(B, S, H, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    c_kv = rmsnorm(params["kv_norm"], x @ params["w_dkv"])
    k_rope = (x @ params["w_kr"]).reshape(B, S, 1, m.qk_rope_head_dim)
    cos, sin = rope_angles(replicated_like(positions, x), m.qk_rope_head_dim, cfg.rope_theta)
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
    k_nope = (rows(c_kv) @ params["w_uk"]).reshape(B, S, H, m.qk_nope_head_dim)
    v = (rows(c_kv) @ params["w_uv"]).reshape(B, S, H, m.v_head_dim)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(B, S, H, m.qk_rope_head_dim)], dim=-1)
    if ctx.flag("attn_heads"):
        q_full = ctx.cons(q_full, ("batch", None, "heads", None))
        k_full = ctx.cons(k_full, ("batch", None, "heads", None))
    else:
        q_full = ctx.cons(q_full, ("batch", "seq", "heads", None))
        k_full = ctx.cons(k_full, ("batch", "seq", "heads", None))
    o = _mla_core(ctx, q_full, k_full, v).reshape(B, S, -1)
    y = rows(o) @ params["wo"]
    return ctx.cons(y, ("batch", "seq", "d_model")), (c_kv, k_rope[:, :, 0, :])


def _mla_core(ctx, q, k, v):
    """The chunked causal attention of q, k (B,S,H,dn+dr) and v (B,S,H,dv),
    v padded to the q/k head width for it and cut back → (B,S,H,dv); on a
    mesh on each rank's blocks: batch over the rules' batch axes, heads over
    the heads' axes, the sequence whole."""

    def fn(q, k, v):
        vp = F.pad(v, (0, q.shape[-1] - v.shape[-1]))
        o = chunked_causal_attention(q.transpose(1, 2), k.transpose(1, 2), vp.transpose(1, 2)).transpose(1, 2)
        return o[..., : v.shape[-1]].contiguous()

    if not _meshed(ctx, q, k, v):
        return fn(q, k, v)
    qs = spec_for(ctx.mesh, ctx.rules, ("batch", None, "heads", None), q.shape)
    return shard_map(fn, ctx.mesh, (qs, qs, qs), qs)(q, k, v)


def mla_decode(params, x, cfg, cache, pos, ctx=NO_CTX):
    """Absorbed decode. x: (B,1,d); cache: {"c_kv": (B,Smax,r), "k_rope":
    (B,Smax,dr)}; pos: (B,) int. Writes this step's latent and rope key at
    ``pos`` in place and returns (y, cache). On a mesh the cache write and
    the scores against the latent run on each rank's block of the cache
    (:func:`_latent_attention_meshed`); the absorbed products follow the
    heads' placement."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkr(params, x, cfg, pos[:, None])
    # absorb: q_lat[h] = q_nope[h] @ W_uk[h]^T scores against the latent itself
    w_uk = params["w_uk"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)  # (B,H,r), in the model's dtype
    scale = math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    if _meshed(ctx, cache["c_kv"]):
        o_lat = _latent_attention_meshed(ctx, q_lat, q_rope[:, 0], c_kv_new, k_rope_new[:, :, 0, :], cache, pos, scale)
    else:
        ckv = _scatter_time(cache["c_kv"], c_kv_new, pos)
        krp = _scatter_time(cache["k_rope"], k_rope_new[:, :, 0, :], pos)
        mask = torch.arange(ckv.shape[1], device=x.device)[None, :] <= pos[:, None]
        o_lat = _latent_attention(q_lat, q_rope[:, 0], ckv, krp, mask, scale)
    w_uv = params["w_uv"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    o = torch.einsum("bhr,rhd->bhd", o_lat, w_uv.float()).to(x.dtype)
    y = o.reshape(B, 1, -1) @ params["wo"]
    return y, cache


def _latent_attention(q_lat, q_rope, ckv, krp, mask, scale, group=None):
    """o_lat (B,H,r) float32: the float32 softmax of q_lat (B,H,r) and
    q_rope (B,H,dr) against the latent rows ``ckv`` (B,n,r) and rope keys
    ``krp`` (B,n,dr) where ``mask`` (B,n) holds, -1e30 elsewhere, over the
    latent rows. With ``group``, the rows are this rank's block of the
    sequence, split over ``group``'s ranks (split-KV decode,
    ``layers.softmax_weighted``)."""
    ckv_f = ckv.float()
    s = torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv_f) + torch.einsum("bhd,bsd->bhs", q_rope.float(), krp.float())
    s = s / scale
    s = s.masked_fill(~mask[:, None, :], -1e30)
    return softmax_weighted(s, lambda p: torch.einsum("bhs,bsr->bhr", p, ckv_f), group)


def _latent_attention_meshed(ctx, q_lat, q_rope, c_kv, k_rope, cache, pos, scale):
    """The decode step's latent-cache write and its attention on a mesh, on
    each rank's block of the cache (batch over the cache's batch axes,
    positions over its ``kv_seq`` axes): q_lat (B,H,r), q_rope (B,H,dr),
    this token's c_kv (B,1,r) and k_rope (B,1,dr), pos (B,). Each rank
    writes the rows at ``pos`` that fall in its block (in place), scores
    its block, and the blocks are combined over the ``kv_seq`` axes. The
    heads are whole on every rank (q gathered once, both parts in one
    tensor). Returns o_lat (B,H,r) float32, batch split as the cache's."""
    mesh = ctx.mesh
    cs = spec_of(cache["c_kv"], mesh)
    off = _local_offsets(cache["c_kv"])[1]
    group = None if cs[1] is None else mesh.axis_group(cs[1])
    row = (cs[0], None, None)
    r = q_lat.shape[-1]

    def region(q, cn, kn, ckv, krp, pos):
        at = pos.long() - off
        _write_rows(ckv, cn, at)
        _write_rows(krp, kn, at)
        mask = (torch.arange(ckv.shape[1], device=ckv.device) + off)[None, :] <= pos[:, None]
        return _latent_attention(q[..., :r], q[..., r:], ckv, krp, mask, scale, group).contiguous()

    q = torch.cat([q_lat, q_rope.to(q_lat.dtype)], dim=-1)
    return shard_map(region, mesh, (row, row, row, cs, cs, (cs[0],)), row)(q, c_kv, k_rope, cache["c_kv"],
                                                                         cache["k_rope"], replicated_like(pos, q))


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
