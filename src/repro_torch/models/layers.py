"""Shared model layers (eager PyTorch, pytree params).

A port of the reference package's ``models/layers.py`` for every family:
norms, RoPE, chunked causal and decode attention, the GQA block, the SwiGLU
and GELU MLPs and the top-k routed MoE block, each with its logical dims
(``*_specs``). Conventions follow the reference step by step:

* params are nested dicts of tensors; every builder has an ``init`` and an
  ``apply``-style function;
* activations are in the model's dtype (bf16 by default); softmax and norms
  compute in float32 and cast back;
* attention is chunked (online softmax over KV blocks of 1024) so a long
  prompt never builds an S×S score tensor — the same chunks and the same
  order of combination as the reference, not PyTorch's fused attention;
* ``Ctx`` is the reference's sharding context: the mesh of ranks and the
  sharding rules, whose flags steer the model (``moe_gather``). With a mesh,
  ``cons`` redistributes a DTensor activation to its logical dims
  (``dist.sharding.constrain``); without one it is the identity.

On a mesh the parameters, the cache and the activations are DTensors and
DTensor's sharding propagation runs the products, norms, RoPE, SwiGLU, the
GELU MLP, the layernorms and the tied head; a constant made on the spot
(positions, RoPE frequencies, the vocabulary pad, the sinusoidal positions)
joins them as a replicated DTensor (:func:`replicated_like`). Regions run
instead on each rank's blocks (``dist._compat.shard_map``, or by hand),
where DTensor has no sharding strategy, would gather the cache or would
dispatch a scan's small ops one at a time:

* the attention core of a full sequence (:func:`chunked_causal_attention`),
  with batch over its axes and heads over theirs, the sequence whole; the
  encoder's bidirectional attention, and the encoder-decoder's
  cross-attention, whose queries (a prompt, or one token a tick) attend all
  of the encoder's frames, go through the same region;
* the decode attention over the cache (:func:`decode_attention`), split
  over the cache's ``kv_seq`` axes as flash-decoding splits it: each rank
  scores its own rows, and a max and two sums over those axes combine them;
* the in-place cache writes: one token's rows at ``pos``
  (``attention_decode``) and a prompt's rows into one slot
  (``models.model._write_slot``), each rank writing the rows it holds;
* the MoE block's expert products (:func:`_experts_meshed`): the router,
  the dispatch and the combine run on the global tokens whole on every rank
  (the reference's capacity and drops), the products on each rank's blocks
  of the expert weights, summed over the axes that split them in one call;
* the MLA family's attention core and its decode over the latent cache
  (``models.mla``), in the same forms as the attention's;
* the recurrent mixers' scans (``models.ssm``): Mamba's causal conv and
  selective scan on each rank's batch rows and ``d_inner`` channels,
  RWKV6's time mix and WKV scan on its batch rows and heads and its channel
  mix on its part of ``d_ff``, time whole, each with the one sum its
  partial products need (:func:`sum_of_parts`, ``_OutOfRegion``); the state
  they return lies as the cache holds it, so the decode writes stay on each
  rank's blocks.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..dist._compat import all_reduce, shard_map
from ..dist.sharding import ShardingRules, constrain, placements_for, spec_for, spec_of, whole_grad


@dataclasses.dataclass(frozen=True)
class Ctx:
    mesh: Any = None
    rules: ShardingRules | None = None

    def cons(self, x, dims):
        """A sharding constraint: ``x`` redistributed to ``dims`` on the mesh;
        the identity without a mesh."""
        if self.mesh is None:
            return x
        return constrain(x, self.mesh, self.rules, dims)

    def flag(self, name: str) -> bool:
        return self.rules is not None and self.rules.has(name)


NO_CTX = Ctx()


def replicated_like(t, ref):
    """``t``, a plain tensor every rank holds whole, as a replicated DTensor
    on ``ref``'s mesh when ``ref`` is a DTensor; otherwise ``t`` itself."""
    if isinstance(ref, DTensor) and not isinstance(t, DTensor):
        return DTensor.from_local(t, ref.device_mesh, [Replicate()] * ref.device_mesh.ndim, run_check=False)
    return t


def rows(x):
    """``x`` ready for a product with a weight: DTensor's product flattens
    the leading dims, which it refuses (torch 2.11) when a dim between the
    first and the last is split, so such a dim is gathered whole first (the
    gather GSPMD inserts around a sequence-split block). Its gradient leaves
    with no pending partial sum (``dist.sharding.whole_grad``)."""
    if not isinstance(x, DTensor):
        return x
    pl = [Replicate() if isinstance(p, Shard) and 0 < p.dim < x.ndim - 1 else p for p in x.placements]
    return whole_grad(x if pl == list(x.placements) else x.redistribute(x.device_mesh, pl))


def _meshed(ctx, *xs) -> bool:
    return ctx.mesh is not None and any(isinstance(x, DTensor) for x in xs)


#: a leaf whose float32 draw would pass this many elements is drawn in slabs
#: along its leading axis (an MoE weight, one expert's rows at a time)
SLAB_ELEMENTS = 1 << 27


@dataclasses.dataclass(frozen=True)
class Block:
    """The part of a drawn leaf of global ``shape`` that one rank keeps:
    ``local`` holds the elements from ``offsets`` on (a rank's block of a
    DTensor; the whole leaf, at offsets 0, in one process)."""

    local: torch.Tensor
    offsets: tuple[int, ...]
    shape: tuple[int, ...]

    @classmethod
    def whole(cls, t: torch.Tensor) -> "Block":
        return cls(t, (0,) * t.ndim, tuple(t.shape))

    def take(self, full: torch.Tensor, row0: int = 0) -> None:
        """Copy the part of ``full`` (rows ``row0`` on of the leaf) that
        falls in this block into ``local``."""
        n, o = self.local.shape, self.offsets
        lo, hi = max(row0, o[0]), min(row0 + len(full), o[0] + n[0])
        if lo >= hi:
            return
        src = full[lo - row0:hi - row0]
        for k in range(1, self.local.ndim):
            src = src.narrow(k, o[k], n[k])
        self.local[lo - o[0]:hi - o[0]].copy_(src)


class DrawInto:
    """Stands in for the generator of an ``*_init`` so that its drawn leaves
    land in tensors that already exist (a layer's views of stacked leaves,
    or a rank's blocks of them): the i-th :func:`truncnorm_init` call draws
    from ``generator`` into ``dests[i]`` (a tensor, or a :class:`Block`) and
    returns the tensor it filled. A leaf is drawn in slabs along its leading
    axis where it passes ``SLAB_ELEMENTS``, each slab whole, and only the
    part of each slab that falls in the destination is kept: every rank
    draws what one process draws, in the same slabs, so a rank's block holds
    the bits of the whole draw. With ``dests=None`` the draws are ``meta``
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
            dest = self.dests[len(self.drawn)]
            dest = dest if isinstance(dest, Block) else Block.whole(dest)
            out = dest.local
            if dest.shape != tuple(shape) or out.dtype != dtype:
                raise ValueError(f"draw {len(self.drawn)}: {tuple(shape)} {dtype} into {dest.shape} {out.dtype}")
            n = shape[0]
            step = n if math.prod(shape) <= SLAB_ELEMENTS else max(1, SLAB_ELEMENTS // math.prod(shape[1:]))
            for i in range(0, n, step):
                dest.take(truncnorm_init(self.generator, (min(step, n - i), *shape[1:]), dtype, scale), i)
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
    return x.mul_(scale).to(dtype)  # scaled in place: a draw holds its float32 values and their cast, no more


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
    freqs = replicated_like(_rope_freqs(head_dim, float(theta), positions.device), positions)
    ang = positions.float()[..., None] * freqs
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


def decode_attention(q, k_cache, v_cache, kv_len_mask, group=None):
    """q: (B,Hq,1,D); caches: (B,Hkv,Smax,D); kv_len_mask: (B,Smax) bool.
    Plain softmax over the cache (linear in Smax). With ``group``, the cache
    rows are this rank's block of the sequence, split over ``group``'s ranks
    (flash-decoding): the row maximum, then the weighted values with the
    exponentials' sum, are combined over the group before the division."""
    B, Hq, _, D = q.shape
    Hkv = k_cache.shape[1]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.float(), k_cache.float())
    s = s * scale
    s = s.masked_fill(~kv_len_mask[:, None, None, :], -1e30)
    o = softmax_weighted(s, lambda p: torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float()), group)
    return o.reshape(B, Hq, 1, D).to(q.dtype)


def softmax_weighted(s, weigh, group=None):
    """``weigh(softmax(s))``, the softmax over the last dim of the float32
    scores ``s`` and ``weigh`` a linear map of the weights (the weighted
    sum of the rows they score). With ``group``, the last dim is this rank's
    block of rows, split over ``group``'s ranks (flash-decoding): the row
    maximum, then the weighted rows with the exponentials' sum (one call),
    are combined over the group before the division."""
    if group is None:
        return weigh(torch.softmax(s, dim=-1))
    m = all_reduce(torch.amax(s, dim=-1, keepdim=True), group, dist.ReduceOp.MAX)
    p = torch.exp(s - m)
    ol = all_reduce(torch.cat([weigh(p), torch.sum(p, dim=-1, keepdim=True)], -1), group)
    return ol[..., :-1] / ol[..., -1:]


def _attention_core(ctx, q, k, v, causal):
    """:func:`chunked_causal_attention` of q (B,S,Hq,D), k/v (B,S,Hkv,D) →
    (B,S,Hq,D); on a mesh on each rank's blocks: batch over the rules' batch
    axes, heads over the heads' axes where q's and k's agree (else whole),
    the sequence whole. The region's blocks stay in this layout (DTensor's
    views need contiguous blocks)."""

    def fn(q, k, v):
        return chunked_causal_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                        causal=causal).transpose(1, 2)

    if not _meshed(ctx, q, k, v):
        return fn(q, k, v)
    qs = spec_for(ctx.mesh, ctx.rules, ("batch", None, "heads", None), q.shape)
    ks = spec_for(ctx.mesh, ctx.rules, ("batch", None, "kv_heads", None), k.shape)
    if qs[2] != ks[2]:  # GQA groups stay whole on a rank only when both split alike
        qs, ks = (qs[0], None, None, None), (ks[0], None, None, None)
    return shard_map(lambda q, k, v: fn(q, k, v).contiguous(), ctx.mesh, (qs, ks, ks), qs)(q, k, v)


def _local_offsets(t: DTensor) -> tuple[int, ...]:
    """The global index of the first element of this rank's block of ``t``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    return tuple(compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)[1])


def _decode_meshed(ctx, q, k, v, cache, pos):
    """The decode step's cache write and attention on a mesh, on each rank's
    blocks of the cache: q (B,1,Hq,D), k/v (B,1,Hkv,D) this token's rows,
    ``cache`` leaves (B,Smax,Hkv,D) DTensors, pos (B,). Each rank writes the
    rows at ``pos`` that fall in its block (in place) and attends its block;
    the blocks are combined over the cache's sequence axes. Returns o
    (B,1,Hq,D), batch split as the cache's."""
    mesh = ctx.mesh
    cs = spec_of(cache["k"], mesh)
    row = (cs[0], None, None, None)
    off = _local_offsets(cache["k"])[1]
    group = None if cs[1] is None else mesh.axis_group(cs[1])

    def region(q, k, v, kc, vc, pos):
        rows = pos.long() - off
        _write_rows(kc, k, rows)
        _write_rows(vc, v, rows)
        n = kc.shape[1]
        mask = (torch.arange(n, device=kc.device) + off)[None, :] <= pos[:, None]
        o = decode_attention(q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2), mask, group)
        return o.transpose(1, 2).contiguous()

    return shard_map(region, mesh, (row, row, row, cs, cs, (cs[0],)), row)(q, k, v, cache["k"], cache["v"],
                                                                          replicated_like(pos, q))


def _write_rows(cache, new, rows):
    """cache: (B, n, ...) a rank's block, new: (B, 1, ...), rows: (B,) local
    row indices → ``cache[b, rows[b]] = new[b, 0]`` in place where the row is
    in [0, n), the row left as it is elsewhere (no host sync)."""
    B, n = cache.shape[0], cache.shape[1]
    ok = (rows >= 0) & (rows < n)
    at = rows.clamp(0, n - 1)
    b = torch.arange(B, device=cache.device)
    keep = ok.reshape((B,) + (1,) * (cache.ndim - 2))
    cache[b, at] = torch.where(keep, new[:, 0].to(cache.dtype), cache[b, at])


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
    x = rows(x)
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q, k, v = _heads(q, H, hd), _heads(k, Hkv, hd), _heads(v, Hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if rope:
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _head_aligned(x, n: int):
    """``x`` (..., n·hd) with a split of its last dim gathered where it does
    not fall on head boundaries (n not a multiple of the ranks that split
    it: 8 KV heads over a model axis of 16), the reshard GSPMD inserts
    there: DTensor refuses to unflatten such a split into heads."""
    if isinstance(x, DTensor):
        split = [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == x.ndim - 1]
        if split and n % math.prod(x.device_mesh.size(i) for i in split):
            x = x.redistribute(x.device_mesh, [Replicate() if i in split else p for i, p in enumerate(x.placements)])
    return x


class _HeadAlignedGrad(torch.autograd.Function):
    """The identity, whose gradient leaves head-aligned (:func:`_head_aligned`):
    the backward of a heads-to-flat reshape unflattens it."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _head_aligned(g, ctx.n), None


def _heads(x, n: int, hd: int):
    """``x`` (..., n·hd) as (..., n, hd), head-aligned first."""
    x = _head_aligned(x, n)
    return x.reshape(*x.shape[:-1], n, hd)


def _flat_heads(o):
    """``o`` (..., n, hd) as (..., n·hd), its gradient head-aligned."""
    flat = o.reshape(*o.shape[:-2], -1)
    return _HeadAlignedGrad.apply(flat, o.shape[-2]) if flat.requires_grad else flat


def attention_fwd(params, x, cfg, ctx=NO_CTX, positions=None, rope=True, causal=True):
    """Training/prefill full-sequence attention. Returns (y, (k, v)) with
    k, v: (B, S, Hkv, hd), the rows a decode cache holds."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q, k, v = _qkv(params, x, cfg, replicated_like(positions, x), rope)
    if ctx.flag("attn_heads"):
        # head-sharded attention internals (Megatron-style): the sequence whole
        q = ctx.cons(q, ("batch", None, "heads", None))
        k = ctx.cons(k, ("batch", None, "kv_heads", None))
        v = ctx.cons(v, ("batch", None, "kv_heads", None))
    else:
        q = ctx.cons(q, ("batch", "seq", "heads", None))
        k = ctx.cons(k, ("batch", "seq", "kv_heads", None))
    o = _flat_heads(_attention_core(ctx, q, k, v, causal))
    y = rows(o) @ params["wo"]
    return ctx.cons(y, ("batch", "seq", "d_model")), (k, v)


def attention_decode(params, x, cfg, cache, pos, ctx=NO_CTX, rope=True):
    """x: (B,1,d); cache: {"k": (B,Smax,Hkv,hd), "v": ...}; pos: (B,) int.
    Writes this step's k and v into ``cache`` at ``pos`` in place and returns
    (y, cache)."""
    B = x.shape[0]
    q, k, v = _qkv(params, x, cfg, replicated_like(pos[:, None], x), rope)
    if _meshed(ctx, cache["k"]):
        o = _decode_meshed(ctx, q, k, v, cache, pos)
        return o.reshape(B, 1, -1) @ params["wo"], cache
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
    x = rows(x)
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    h = ctx.cons(h, ("batch", "seq", "d_ff"))
    return ctx.cons(rows(h) @ params["w_down"], ("batch", "seq", "d_model"))


def gelu_mlp_init(generator, d, d_ff, dtype=torch.bfloat16):
    dev = init_device(generator)
    return {
        "w_up": truncnorm_init(generator, (d, d_ff), dtype),
        "b_up": torch.zeros((d_ff,), dtype=dtype, device=dev),
        "w_down": truncnorm_init(generator, (d_ff, d), dtype),
        "b_down": torch.zeros((d,), dtype=dtype, device=dev),
    }


def gelu_mlp_specs():
    return {
        "w_up": ("d_model", "d_ff"),
        "b_up": ("d_ff",),
        "w_down": ("d_ff", "d_model"),
        "b_down": ("d_model",),
    }


def gelu_mlp(params, x, ctx=NO_CTX):
    """The encoder's MLP: biases before the activation and after
    ``w_down``; the GELU is the tanh approximation (``jax.nn.gelu``'s
    default)."""
    h = F.gelu(rows(x) @ params["w_up"] + params["b_up"], approximate="tanh")
    h = ctx.cons(h, ("batch", "seq", "d_ff"))
    return ctx.cons(rows(h) @ params["w_down"] + params["b_down"], ("batch", "seq", "d_model"))


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

    On a mesh the router, the dispatch and the combine run on the global
    tokens, whole on every rank alike (the capacity and the drops are the
    reference's, which GSPMD computes over all T tokens), and the expert
    products on each rank's blocks of the weights (:func:`_experts_meshed`).
    """
    mc = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = mc.n_experts, mc.top_k
    meshed = _meshed(ctx, x, params["w_gate"])
    xt = (_whole(x) if meshed else x).reshape(T, d)
    dev = xt.device
    logits, gate_vals, eidx = moe_route(_whole(params["router"]), xt, cfg)

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
    if meshed:
        out_b = _experts_meshed(params, eb, ctx).reshape(E * C, d)
    else:
        eb = ctx.cons(eb, ("experts", None, "d_model"))
        h = F.silu(torch.bmm(eb, params["w_gate"])) * torch.bmm(eb, params["w_up"])
        h = ctx.cons(h, ("experts", None, "moe_ff"))
        out_b = torch.bmm(h, params["w_down"]).reshape(E * C, d)
    contrib = out_b[buf_idx] * (sg * keep.to(sg.dtype))[:, None]
    out = _combine(contrib, st, T, k).to(x.dtype).reshape(B, S, d)
    # load-balance aux loss (Switch): E * Σ_e f_e · p_e
    me = torch.softmax(logits, dim=-1).mean(0)
    ce = torch.bincount(flat_e, minlength=E).float() / (T * k)
    aux = E * torch.sum(me * ce)
    if meshed:  # every rank holds the whole result: each keeps its block
        out = ctx.cons(replicated_like(out, x), ("batch", "seq", "d_model"))
        aux = replicated_like(aux, x)
    if mc.shared_ff:
        out = out + swiglu(params["shared"], x, ctx)
    return ctx.cons(out, ("batch", "seq", "d_model")), aux


def _whole(t):
    """A DTensor's full tensor (every rank the same; its gradient goes back
    to each rank's block); anything else as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


class _IntoRegion(torch.autograd.Function):
    """The identity on a tensor every rank of ``group`` holds whole, whose
    gradient is summed over ``group``: each rank's products use a part of
    it, and the whole gradient is the sum of the parts."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


class _OutOfRegion(torch.autograd.Function):
    """The sum over ``group`` of each rank's part; its gradient, the same on
    every rank of the group (what follows runs whole on every rank), goes
    back to each part as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOfParts(torch.autograd.Function):
    """The sum over ``group`` of each rank's part, where each rank goes on
    with the sum on its own part of the work (its channels, its heads): the
    sum's gradient on each rank is then a part of the whole, so the backward
    sums it over ``group`` too and every part gets the whole."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


def sum_of_parts(x, group):
    """:class:`_SumOfParts` over ``group``; ``x`` itself without one."""
    return x if group is None else _SumOfParts.apply(x, group)


def spec_axes(*entries) -> tuple[str, ...]:
    """The mesh axes that spec entries name (an axis, a tuple of them, or
    ``None``), in order."""
    return tuple(a for e in entries for a in ((e,) if isinstance(e, str) else e or ()))


def _experts_meshed(params, eb, ctx):
    """The expert products of :func:`moe_block` on a mesh: ``eb`` (E, C, d),
    whole on every rank, against each rank's block of the expert weights,
    its experts and its part of ``moe_ff`` as the rules place them
    (``expert_d``, FSDP'd under the baseline rules, is gathered whole). Each
    rank writes its experts' partial ``w_down`` products into a zero
    (E, C, d) buffer, and one sum over the axes that split the weights
    makes the whole result on every rank: the partial products over
    ``moe_ff`` add up and the experts' rows fall into place."""
    mesh, rules = ctx.mesh, ctx.rules
    E, _, d = eb.shape
    ws = spec_for(mesh, rules, ("experts", None, "moe_ff"), params["w_gate"].shape)
    specs = {"w_gate": ws, "w_up": ws, "w_down": (ws[0], ws[2], None)}
    blocks = {}
    for name, spec in specs.items():
        w = params[name]
        pl = placements_for(mesh, spec)
        blocks[name] = w if tuple(w.placements) == pl else w.redistribute(mesh.device_mesh, pl)
    e0, el = _local_offsets(blocks["w_gate"])[0], blocks["w_gate"].to_local().shape[0]
    axes = spec_axes(ws[0], ws[2])
    group = mesh.axis_group(axes) if axes else None
    wg, wu, wd = (blocks[n].to_local() for n in ("w_gate", "w_up", "w_down"))
    if group is not None:
        eb = _IntoRegion.apply(eb, group)
    ebl = eb[e0:e0 + el]
    h = F.silu(torch.bmm(ebl, wg)) * torch.bmm(ebl, wu)
    part = F.pad(torch.bmm(h, wd), (0, 0, 0, 0, e0, E - e0 - el))
    return part if group is None else _OutOfRegion.apply(part, group)


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
