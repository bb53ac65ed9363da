"""Shared model layers (eager PyTorch, pytree params).

A port of the reference package's ``models/layers.py`` for the dense,
MoE and MLA decoders: norms, RoPE, chunked causal and decode attention, the GQA
block, the SwiGLU MLP and the top-k routed MoE block, each with its logical
dims (``*_specs``). Conventions follow the reference step by step:

* params are nested dicts of tensors; every builder has an ``init`` and an
  ``apply``-style function;
* activations are in the model's dtype (bf16 by default); softmax and norms
  compute in float32 and cast back;
* attention is chunked (online softmax over KV blocks of 1024) so a long
  prompt never builds an S×S score tensor — the same chunks and the same
  order of combination as the reference, not PyTorch's fused attention;
* ``Ctx`` is the reference's sharding context. It carries the sharding
  rules, whose flags steer the model (``moe_gather``); on one device
  ``cons`` is the identity (placing arrays across devices is ROADMAP.md
  queue A3).

The GELU MLP and the layernorm blocks of the encoder-decoder wait for a
later slice (ROADMAP.md queue A4).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..dist.sharding import ShardingRules


@dataclasses.dataclass(frozen=True)
class Ctx:
    rules: ShardingRules | None = None

    def cons(self, x, dims):
        """A sharding constraint in the reference; the identity on one device."""
        return x

    def flag(self, name: str) -> bool:
        return self.rules is not None and self.rules.has(name)


NO_CTX = Ctx()


#: a leaf whose float32 draw would pass this many elements is drawn in slabs
#: along its leading axis (an MoE weight, one expert's rows at a time)
SLAB_ELEMENTS = 1 << 27


class DrawInto:
    """Stands in for the generator of an ``*_init`` so that its drawn leaves
    land in tensors that already exist (a layer's views of stacked leaves):
    the i-th :func:`truncnorm_init` call draws from ``generator`` into
    ``dests[i]`` and returns it. With ``dests=None`` the draws are ``meta``
    tensors; either way ``drawn`` lists what each call returned, in call
    order. Leaves the init makes without drawing (ones, zeros) are made as
    usual, on the generator's device."""

    def __init__(self, generator: torch.Generator | None, dests: list | None = None):
        self.generator = generator
        self.dests = dests
        self.drawn: list[torch.Tensor] = []

    def draw(self, shape, dtype, scale) -> torch.Tensor:
        if self.dests is None:
            out = torch.empty(shape, dtype=dtype, device="meta")
        else:
            out = self.dests[len(self.drawn)]
            if tuple(out.shape) != tuple(shape) or out.dtype != dtype:
                raise ValueError(f"draw {len(self.drawn)}: {tuple(shape)} {dtype} into {tuple(out.shape)} {out.dtype}")
            row = math.prod(shape[1:])
            step = len(out) if math.prod(shape) <= SLAB_ELEMENTS else max(1, SLAB_ELEMENTS // row)
            for i in range(0, len(out), step):
                out[i:i + step].copy_(truncnorm_init(self.generator, (min(step, len(out) - i), *shape[1:]), dtype,
                                                     scale))
        self.drawn.append(out)
        return out


def init_device(generator) -> torch.device:
    """Where an ``*_init`` builds its tensors: the generator's device, or the
    ``meta`` device (shapes and dtypes, no storage) for ``None``."""
    if isinstance(generator, DrawInto):
        generator = generator.generator
    return torch.device("meta") if generator is None else generator.device


def truncnorm_init(generator, shape, dtype, scale=0.02) -> torch.Tensor:
    """``scale`` × a standard normal truncated to [-2, 2], drawn in float32
    from ``generator`` on its device, then cast to ``dtype`` (a meta tensor
    for ``generator=None``; into the next destination for a
    :class:`DrawInto`)."""
    if isinstance(generator, DrawInto):
        return generator.draw(shape, dtype, scale)
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


def attention_specs(cfg):
    s = {
        "wq": ("d_model", "heads"),
        "wk": ("d_model", "kv_heads"),
        "wv": ("d_model", "kv_heads"),
        "wo": ("heads", "d_model"),
    }
    if cfg.qkv_bias:
        s |= {"bq": ("heads",), "bk": ("kv_heads",), "bv": ("kv_heads",)}
    if cfg.qk_norm:
        s |= {"q_norm": {"scale": ("head_dim",)}, "k_norm": {"scale": ("head_dim",)}}
    return s


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
# MLPs
# ---------------------------------------------------------------------------


def swiglu_init(generator, d, d_ff, dtype=torch.bfloat16):
    return {
        "w_gate": truncnorm_init(generator, (d, d_ff), dtype),
        "w_up": truncnorm_init(generator, (d, d_ff), dtype),
        "w_down": truncnorm_init(generator, (d_ff, d), dtype),
    }


def swiglu_specs():
    return {
        "w_gate": ("d_model", "d_ff"),
        "w_up": ("d_model", "d_ff"),
        "w_down": ("d_ff", "d_model"),
    }


def swiglu(params, x, ctx=NO_CTX):
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    h = ctx.cons(h, ("batch", "seq", "d_ff"))
    return ctx.cons(h @ params["w_down"], ("batch", "seq", "d_model"))


# ---------------------------------------------------------------------------
# MoE (top-k, capacity-based sort dispatch — FLOPs ∝ active experts)
# ---------------------------------------------------------------------------


def moe_init(generator, cfg, dtype=torch.bfloat16):
    mc = cfg.moe
    d = cfg.d_model
    p = {
        "router": truncnorm_init(generator, (d, mc.n_experts), torch.float32, scale=0.006),
        "w_gate": truncnorm_init(generator, (mc.n_experts, d, mc.expert_ff), dtype),
        "w_up": truncnorm_init(generator, (mc.n_experts, d, mc.expert_ff), dtype),
        "w_down": truncnorm_init(generator, (mc.n_experts, mc.expert_ff, d), dtype),
    }
    if mc.shared_ff:
        p["shared"] = swiglu_init(generator, d, mc.shared_ff, dtype)
    return p


def moe_specs(cfg):
    # expert weights use the dedicated "expert_d" logical name so profiles
    # can exclude them from FSDP while keeping dense params sharded
    s = {
        "router": ("d_model", "experts"),
        "w_gate": ("experts", "expert_d", "moe_ff"),
        "w_up": ("experts", "expert_d", "moe_ff"),
        "w_down": ("experts", "moe_ff", "expert_d"),
    }
    if cfg.moe.shared_ff:
        s["shared"] = swiglu_specs()
    return s


def moe_route(router, xt, cfg):
    """The router of :func:`moe_block`: xt (T, d) → (logits (T, E) float32,
    gate values (T, k) float32, expert indices (T, k) int64).

    The top k come from a stable descending sort, so that on ties the lower
    expert index comes first, as ``jax.lax.top_k`` orders them."""
    mc = cfg.moe
    k = mc.top_k
    logits = xt.float() @ router.float()
    if mc.router_softmax_topk:  # softmax-then-topk (Switch/Mixtral style)
        probs = torch.softmax(logits, dim=-1)
        gate_vals, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate_vals, eidx = gate_vals[:, :k], eidx[:, :k]
    else:  # topk-then-softmax (DeepSeek style normalization)
        gate_logits, eidx = torch.sort(logits, dim=-1, descending=True, stable=True)
        gate_vals, eidx = torch.softmax(gate_logits[:, :k], dim=-1), eidx[:, :k]
    if mc.norm_topk_prob:
        gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    return logits, gate_vals, eidx


def moe_capacity(T: int, cfg) -> int:
    """Slots an expert has for ``T`` tokens: C = max(⌈T·k/E · capacity
    factor⌉, 4)."""
    mc = cfg.moe
    return max(int(math.ceil(T * mc.top_k / mc.n_experts * mc.capacity_factor)), 4)


def moe_block(params, x, cfg, ctx=NO_CTX):
    """Top-k routed experts with capacity-factor sort-based dispatch.

    Gathers/scatters move tokens into per-expert buffers of capacity
    C = ceil(T·k/E · capacity_factor); expert products are dense
    (E, C, d)×(E, d, f) batched matmuls. Overflowing tokens are dropped
    (standard GShard/Switch semantics). Returns (out, aux), the Switch
    load-balance term ``E · Σ_e f_e · p_e``.

    Both forms (scatter, and gather under ``ctx.flag("moe_gather")``)
    combine alike, in a fixed order (:func:`_combine`), so they give the
    same bits as each other and from run to run at any top-k.
    """
    mc = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = mc.n_experts, mc.top_k
    dev = x.device
    xt = x.reshape(T, d)
    logits, gate_vals, eidx = moe_route(params["router"], xt, cfg)

    C = moe_capacity(T, cfg)
    # flatten (token, slot) pairs and sort by expert id (stable)
    flat_e = eidx.reshape(-1)  # (T*k,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    flat_g = gate_vals.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    # position within expert group
    same = torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev), (se[1:] == se[:-1]).long()])
    seg_pos = _segment_rank(same)
    keep = seg_pos < C
    buf_idx = se * C + torch.where(keep, seg_pos, 0)
    if ctx.flag("moe_gather"):
        # gather-form dispatch: slot (e, c) pulls its token; dropped pairs
        # write the sentinel slot E*C, which is cut off
        slot_token = torch.full((E * C + 1,), T, dtype=torch.int64, device=dev)
        slot_token[torch.where(keep, buf_idx, E * C)] = st
        xt_pad = torch.cat([xt, torch.zeros((1, d), dtype=xt.dtype, device=dev)])
        eb = xt_pad[slot_token[: E * C]].reshape(E, C, d)
    else:
        # scatter-form dispatch (baseline)
        vals = torch.where(keep[:, None], xt[st], 0).to(x.dtype)
        buf = torch.zeros((E * C, d), dtype=x.dtype, device=dev).index_add(0, buf_idx, vals)
        eb = buf.reshape(E, C, d)  # collisions only among dropped → add of 0s
    eb = ctx.cons(eb, ("experts", None, "d_model"))
    h = F.silu(torch.bmm(eb, params["w_gate"])) * torch.bmm(eb, params["w_up"])
    h = ctx.cons(h, ("experts", None, "moe_ff"))
    out_b = torch.bmm(h, params["w_down"]).reshape(E * C, d)
    contrib = out_b[buf_idx] * (sg * keep.to(sg.dtype))[:, None]
    out = _combine(contrib, st, T, k).to(x.dtype).reshape(B, S, d)
    if mc.shared_ff:
        out = out + swiglu(params["shared"], x, ctx)
    # load-balance aux loss (Switch): E * Σ_e f_e · p_e
    me = torch.softmax(logits, dim=-1).mean(0)
    ce = torch.bincount(flat_e, minlength=E).float() / (T * k)
    aux = E * torch.sum(me * ce)
    return ctx.cons(out, ("batch", "seq", "d_model")), aux


def _combine(contrib, st, T: int, k: int):
    """Each token's k float32 contributions summed: ``contrib`` (T·k, d) in
    expert-sorted order, ``st`` the token of each row. Every token has
    exactly k rows (a dropped pair's is zero); the inverse of the expert
    sort groups them by token in ascending expert order, and they are added
    onto zero left to right, in that order (a scatter ``index_add_`` on the
    card would add in whatever order its atomics land). So both dispatch
    forms and every run give the same bits at any top-k, and for k ≤ 2 the
    bits ``index_add_`` gives (two terms added onto zero give the same bits
    in either order)."""
    rows = contrib[torch.argsort(st, stable=True)].reshape(T, k, -1).float()
    out = torch.zeros_like(rows[:, 0])
    for j in range(k):
        out = out + rows[:, j]
    return out


def _segment_rank(same_as_prev):
    """Given 0/1 'same as previous' flags of a sorted array, return the rank
    of each element within its run (the start of each run by a running
    maximum)."""
    n = same_as_prev.shape[0]
    idx = torch.arange(n, device=same_as_prev.device)
    starts = torch.cummax(torch.where(same_as_prev == 0, idx, 0), dim=0).values
    return idx - starts
