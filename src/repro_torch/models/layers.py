"""Shared model layers, the dense subset (eager PyTorch, pytree params).

A port of the reference package's ``models/layers.py`` for the dense
decoder: norms, RoPE, chunked causal and decode attention, the GQA block
and the SwiGLU MLP. Conventions follow the reference step by step:

* params are nested dicts of tensors; every builder has an ``init`` and an
  ``apply``-style function;
* activations are in the model's dtype (bf16 by default); softmax and norms
  compute in float32 and cast back;
* attention is chunked (online softmax over KV blocks of 1024) so a long
  prompt never builds an S×S score tensor — the same chunks and the same
  order of combination as the reference, not PyTorch's fused attention;
* ``Ctx`` is the reference's sharding context; on one device ``cons`` is
  the identity and there is nothing to carry (the sharding substrate is
  ROADMAP.md queue A3).

The MoE block and the GELU MLP wait for a later slice.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


class Ctx:
    def cons(self, x, dims):
        """A sharding constraint in the reference; the identity here."""
        return x


NO_CTX = Ctx()


def init_device(generator: torch.Generator | None) -> torch.device:
    """Where an ``*_init`` builds its tensors: the generator's device, or the
    ``meta`` device (shapes and dtypes, no storage) for ``None``."""
    return torch.device("meta") if generator is None else generator.device


def truncnorm_init(generator: torch.Generator | None, shape, dtype, scale=0.02) -> torch.Tensor:
    """``scale`` × a standard normal truncated to [-2, 2], drawn in float32
    from ``generator`` on its device, then cast to ``dtype`` (a meta tensor
    for ``generator=None``)."""
    x = torch.empty(shape, dtype=torch.float32, device=init_device(generator))
    if generator is not None:
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (scale * x).to(dtype)


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------


def rmsnorm_init(d, dtype=torch.bfloat16, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_init(d, dtype=torch.bfloat16, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params, x, eps=1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


@functools.lru_cache(maxsize=8)
def _rope_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """The RoPE frequencies, built in numpy float32 as the reference builds
    them, copied to ``device`` once."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2.0 / head_dim))
    return torch.from_numpy(np.asarray(freqs, dtype=np.float32)).to(device)


def rope_angles(positions, head_dim, theta):
    """positions: (...,) int → (cos, sin): (..., head_dim/2) float32."""
    ang = positions.float()[..., None] * _rope_freqs(head_dim, float(theta), positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., S, H, D); cos/sin: (..., S, 1, D/2) or broadcastable. Rotates
    the two halves of the head (not interleaved pairs)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# chunked causal attention (online softmax — no S×S tensor)
# ---------------------------------------------------------------------------


def _attn_chunk(q, k, v, scale, mask):
    """q: (B,Hq,Tq,D) k/v: (B,Hkv,Tk,D); GQA via head grouping. mask: (Tq,Tk)
    or None. Returns (out_unnorm f32, row_max f32, row_sum f32)."""
    B, Hq, Tq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Tq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float())
    s = s * scale
    if mask is not None:
        s = s.masked_fill(~mask[None, None, None], -1e30)
    m = torch.amax(s, dim=-1)  # (B,Hkv,G,Tq)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o, m, l


def chunked_causal_attention(q, k, v, *, chunk_q=1024, chunk_k=1024, causal=True, q_offset=0):
    """q: (B,Hq,Sq,D), k/v: (B,Hkv,Sk,D) → (B,Hq,Sq,D) in q.dtype.

    Online softmax over KV chunks inside a loop over Q chunks. ``q_offset``
    is the absolute position of q[0] (for prefill continuation / decode).
    """
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    cq = min(chunk_q, Sq)
    ck = min(chunk_k, Sk)
    # pad to multiples
    pq = (-Sq) % cq
    pk = (-Sk) % ck
    qp = F.pad(q, (0, 0, 0, pq))
    kp = F.pad(k, (0, 0, 0, pk))
    vp = F.pad(v, (0, 0, 0, pk))
    nq, nk = qp.shape[2] // cq, kp.shape[2] // ck

    dev = q.device
    q_pos = torch.arange(cq, device=dev)
    k_pos = torch.arange(ck, device=dev)
    outs = []
    for iq in range(nq):
        qc = qp[:, :, iq * cq:(iq + 1) * cq]
        o = torch.zeros((B, Hkv, G, cq, D), dtype=torch.float32, device=dev)
        m = torch.full((B, Hkv, G, cq), -1e30, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hkv, G, cq), dtype=torch.float32, device=dev)
        for ik in range(nk):
            kc = kp[:, :, ik * ck:(ik + 1) * ck]
            vc = vp[:, :, ik * ck:(ik + 1) * ck]
            abs_k = ik * ck + k_pos
            valid = abs_k < Sk  # mask KV PADDING (ragged Sk) in every mode
            if causal:
                abs_q = q_offset + iq * cq + q_pos
                mask = (abs_q[:, None] >= abs_k[None, :]) & valid[None, :]
            else:
                mask = valid[None, :].expand(cq, ck)
            oc, mc, lc = _attn_chunk(qc, kc, vc, scale, mask)
            m_new = torch.maximum(m, mc)
            alpha = torch.exp(m - m_new)
            beta = torch.exp(mc - m_new)
            o = o * alpha[..., None] + oc * beta[..., None]
            l = l * alpha + lc * beta
            m = m_new
        out = o / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.reshape(B, Hq, cq, D).to(q.dtype))
    out = torch.cat(outs, dim=2)
    return out[:, :, :Sq]


def decode_attention(q, k_cache, v_cache, kv_len_mask):
    """q: (B,Hq,1,D); caches: (B,Hkv,Smax,D); kv_len_mask: (B,Smax) bool.
    Plain softmax over the cache (linear in Smax)."""
    B, Hq, _, D = q.shape
    Hkv = k_cache.shape[1]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.float(), k_cache.float())
    s = s * scale
    s = s.masked_fill(~kv_len_mask[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return o.reshape(B, Hq, 1, D).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------


def attention_init(generator, cfg, dtype=torch.bfloat16):
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = init_device(generator)
    p = {
        "wq": truncnorm_init(generator, (d, H * hd), dtype),
        "wk": truncnorm_init(generator, (d, Hkv * hd), dtype),
        "wv": truncnorm_init(generator, (d, Hkv * hd), dtype),
        "wo": truncnorm_init(generator, (H * hd, d), dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((Hkv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((Hkv * hd,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, dev)
        p["k_norm"] = rmsnorm_init(hd, dtype, dev)
    return p


def _qkv(params, x, cfg, positions, rope=True):
    B, S, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, Hkv, hd)
    v = v.reshape(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if rope:
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def attention_fwd(params, x, cfg, ctx=NO_CTX, positions=None, rope=True, causal=True):
    """Training/prefill full-sequence attention. Returns (y, (k, v)) with
    k, v: (B, S, Hkv, hd), the rows a decode cache holds."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q, k, v = _qkv(params, x, cfg, positions, rope)
    o = chunked_causal_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal)
    o = o.transpose(1, 2).reshape(B, S, -1)
    y = o @ params["wo"]
    return ctx.cons(y, ("batch", "seq", "d_model")), (k, v)


def attention_decode(params, x, cfg, cache, pos, ctx=NO_CTX, rope=True):
    """x: (B,1,d); cache: {"k": (B,Smax,Hkv,hd), "v": ...}; pos: (B,) int.
    Writes this step's k and v into ``cache`` at ``pos`` in place and returns
    (y, cache)."""
    B = x.shape[0]
    q, k, v = _qkv(params, x, cfg, pos[:, None], rope)
    kc = _scatter_time(cache["k"], k, pos)
    vc = _scatter_time(cache["v"], v, pos)
    Smax = kc.shape[1]
    mask = torch.arange(Smax, device=x.device)[None, :] <= pos[:, None]
    o = decode_attention(q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2), mask)
    y = o.transpose(1, 2).reshape(B, 1, -1) @ params["wo"]
    return y, cache


def _scatter_time(cache, new, pos):
    """cache: (B, Smax, ...), new: (B, 1, ...), pos: (B,) → ``cache`` with
    row ``[b, pos[b]]`` set to ``new[b, 0]``, written in place."""
    B = cache.shape[0]
    cache[torch.arange(B, device=cache.device), pos.long()] = new[:, 0].to(cache.dtype)
    return cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def swiglu_init(generator, d, d_ff, dtype=torch.bfloat16):
    return {
        "w_gate": truncnorm_init(generator, (d, d_ff), dtype),
        "w_up": truncnorm_init(generator, (d, d_ff), dtype),
        "w_down": truncnorm_init(generator, (d_ff, d), dtype),
    }


def swiglu(params, x, ctx=NO_CTX):
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    h = ctx.cons(h, ("batch", "seq", "d_ff"))
    return ctx.cons(h @ params["w_down"], ("batch", "seq", "d_model"))
