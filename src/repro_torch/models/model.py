"""Model assembly: decoder-only LM / MoE / MLA / SSM / hybrid / enc-dec / VLM.

A model is a layer PATTERN: a non-repeated prefix (``prefix_{i}``: DeepSeek-V3's
leading dense MLA layers; empty for the other families) plus a
repeated body period (Jamba's: Mamba layers, dense or MoE, around one
attention layer) whose parameters (and decode cache) are stacked over
the repeats, so every body leaf has a leading ``n_layers`` axis — the
reference's pytree, leaf for leaf, which is what the coded-serving guard
reads and what a checkpoint holds. The reference scans the body with
``jax.lax.scan``; here a Python loop indexes the stacked tensors.

The encoder-decoder (Whisper) adds an ``encoder`` leaf: a stacked
bidirectional encoder (layernorm, GELU MLP, sinusoidal positions, no RoPE)
over precomputed frame embeddings (the stub frontend) and one
cross-attention block after each decoder layer; its decode cache holds the
encoder's output as ``enc_out``. The VLM (InternVL2) puts precomputed patch
embeddings (the stub frontend) before the text tokens in ``forward``; its
decode is text only, as the reference's.

Public surface (used by train/, serve/, launch/):
    build_model(cfg)        → Model
    model.init(generator)   → params (on the generator's device)
    model.param_specs()     → the params' pytree as ``meta`` tensors
    model.param_dims()      → the params' logical dims (``dist.sharding``)
    model.forward(params, batch, ctx)          → (logits, aux, hidden)
    model.loss(params, batch, ctx)             → (loss, {"ce", "aux", ["mtp_ce",] "loss"})
    model.init_cache(batch, s_max) / model.cache_dims()
    model.prefill(params, batch, ctx)          → forward
    model.decode_step(params, cache, tokens, pos, ctx) → (logits, cache)
    model.prefill_into_cache(params, cache, tokens, slot, ctx)
                            → (logits, cache)   # one-pass KV fill of a slot
    model.supports_prefill  → bool

Every layer kind of the reference (``"dense"``, ``"moe"``, ``"mla_dense"``,
``"mla_moe"``, ``"mamba"``, ``"mamba_moe"``, ``"rwkv"``), the
multi-token-prediction head (``mtp``), the encoder with its cross-attention
and the patch prefix are ported: ``build_model`` builds every config of the
registry. Decode and prefill write the cache in place and return it. A
recurrent layer (Mamba, RWKV) keeps a state with no per-position rows, and
the encoder-decoder and VLM frontends have no per-position cache, so these
models have no one-pass prefill: they are served by the fixed ``Engine``'s
per-token refeed.

Every family runs on a mesh of ranks (``Ctx(mesh=)``, DTensor parameters,
cache and activations): the recurrent mixers' scans, the attention cores
(the encoder's and the cross-attention's too) and the MoE experts in
regions on each rank's blocks (``models.layers``, ``models.ssm``), the rest
as DTensor ops. The patch prefix and the text are each gathered whole in
the sequence before they are joined, and the text cut out again after the
trunk, so their positions are the reference's whatever the rules split.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from torch.distributed.tensor import DTensor, Replicate, Shard

from .. import tree
from ..configs.base import ModelConfig
from ..core.field import resolve_device
from ..dist._compat import shard_map
from ..dist.sharding import is_dims, spec_of, whole_grad
from . import layers as L
from . import mla as MLA
from . import ssm as SSM

# ---------------------------------------------------------------------------
# layer-kind registry
# ---------------------------------------------------------------------------


def _dense_init(generator, cfg, dtype, d_ff=None):
    dev = L.init_device(generator)
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, dtype, dev),
        "attn": L.attention_init(generator, cfg, dtype),
        "ln2": L.rmsnorm_init(cfg.d_model, dtype, dev),
        "mlp": L.swiglu_init(generator, cfg.d_model, d_ff or cfg.d_ff, dtype),
    }


def _dense_specs(cfg):
    return {
        "ln1": {"scale": ("d_model",)},
        "attn": L.attention_specs(cfg),
        "ln2": {"scale": ("d_model",)},
        "mlp": L.swiglu_specs(),
    }


def _dense_fwd(params, x, cfg, ctx, aux):
    h, _ = L.attention_fwd(params["attn"], L.rmsnorm(params["ln1"], x), cfg, ctx)
    x = x + h
    x = x + L.swiglu(params["mlp"], L.rmsnorm(params["ln2"], x), ctx)
    return x, aux


def _dense_decode(params, x, cfg, cache, pos, ctx):
    h, cache2 = L.attention_decode(params["attn"], L.rmsnorm(params["ln1"], x), cfg, cache, pos, ctx)
    x = x + h
    x = x + L.swiglu(params["mlp"], L.rmsnorm(params["ln2"], x), ctx)
    return x, cache2


def _dense_prefill(params, x, cfg, ctx, aux):
    """Full-sequence forward that also returns this layer's cache content
    (the K/V rows for positions [0, S)): the decode path's cache is filled in
    ONE pass instead of a per-token refeed."""
    h, (k, v) = L.attention_fwd(params["attn"], L.rmsnorm(params["ln1"], x), cfg, ctx)
    x = x + h
    x = x + L.swiglu(params["mlp"], L.rmsnorm(params["ln2"], x), ctx)
    return x, aux, {"k": k, "v": v}


def _kv_cache_init(cfg, batch, s_max, dtype, device, layers: int | None = None):
    lead = () if layers is None else (layers,)
    shape = (*lead, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _kv_cache_dims():
    return {
        "k": ("batch", "kv_seq", "kv_heads", "head_dim"),
        "v": ("batch", "kv_seq", "kv_heads", "head_dim"),
    }


def _moe_init(generator, cfg, dtype):
    dev = L.init_device(generator)
    p = {
        "ln1": L.rmsnorm_init(cfg.d_model, dtype, dev),
        "attn": L.attention_init(generator, cfg, dtype),
        "ln2": L.rmsnorm_init(cfg.d_model, dtype, dev),
        "moe": L.moe_init(generator, cfg, dtype),
    }
    if cfg.moe.dense_residual_ff:
        p["dense_mlp"] = L.swiglu_init(generator, cfg.d_model, cfg.moe.dense_residual_ff, dtype)
    return p


def _moe_specs(cfg):
    s = {
        "ln1": {"scale": ("d_model",)},
        "attn": L.attention_specs(cfg),
        "ln2": {"scale": ("d_model",)},
        "moe": L.moe_specs(cfg),
    }
    if cfg.moe.dense_residual_ff:
        s["dense_mlp"] = L.swiglu_specs()
    return s


def _moe_mlp(params, xn, cfg, ctx):
    """The routed experts plus, where the config has one, the dense residual
    SwiGLU beside them (Arctic). Returns (out, aux)."""
    mo, a = L.moe_block(params["moe"], xn, cfg, ctx)
    if cfg.moe.dense_residual_ff:
        mo = mo + L.swiglu(params["dense_mlp"], xn, ctx)
    return mo, a


def _moe_fwd(params, x, cfg, ctx, aux):
    h, _ = L.attention_fwd(params["attn"], L.rmsnorm(params["ln1"], x), cfg, ctx)
    x = x + h
    mo, a = _moe_mlp(params, L.rmsnorm(params["ln2"], x), cfg, ctx)
    return x + mo, aux + a


def _moe_decode(params, x, cfg, cache, pos, ctx):
    h, cache2 = L.attention_decode(params["attn"], L.rmsnorm(params["ln1"], x), cfg, cache, pos, ctx)
    x = x + h
    mo, _ = _moe_mlp(params, L.rmsnorm(params["ln2"], x), cfg, ctx)
    return x + mo, cache2


def _moe_prefill(params, x, cfg, ctx, aux):
    h, (k, v) = L.attention_fwd(params["attn"], L.rmsnorm(params["ln1"], x), cfg, ctx)
    x = x + h
    mo, a = _moe_mlp(params, L.rmsnorm(params["ln2"], x), cfg, ctx)
    return x + mo, aux + a, {"k": k, "v": v}


def _ffn(params, x, cfg, ctx, aux):
    """The second half of an MLA or Mamba layer: x plus the routed experts
    (``params["moe"]``) or the SwiGLU (``params["mlp"]``) of ``ln2``(x).
    Returns (x, aux)."""
    xn = L.rmsnorm(params["ln2"], x)
    if "moe" in params:
        mo, a = L.moe_block(params["moe"], xn, cfg, ctx)
        return x + mo, aux + a
    return x + L.swiglu(params["mlp"], xn, ctx), aux


def _mla_block(moe: bool) -> dict[str, Any]:
    """The ``"mla_moe"`` (``moe``) or ``"mla_dense"`` layer kind: MLA, then the
    routed experts or a SwiGLU of ``moe.dense_ff`` (DeepSeek-V3's leading
    dense layers)."""

    def init(generator, cfg, dtype):
        dev = L.init_device(generator)
        p = {
            "ln1": L.rmsnorm_init(cfg.d_model, dtype, dev),
            "attn": MLA.mla_init(generator, cfg, dtype),
            "ln2": L.rmsnorm_init(cfg.d_model, dtype, dev),
        }
        if moe:
            p["moe"] = L.moe_init(generator, cfg, dtype)
        else:
            p["mlp"] = L.swiglu_init(generator, cfg.d_model, cfg.moe.dense_ff or cfg.d_ff, dtype)
        return p

    def specs(cfg):
        return {
            "ln1": {"scale": ("d_model",)},
            "attn": MLA.mla_specs(cfg),
            "ln2": {"scale": ("d_model",)},
            **({"moe": L.moe_specs(cfg)} if moe else {"mlp": L.swiglu_specs()}),
        }

    def fwd(params, x, cfg, ctx, aux):
        h, _ = MLA.mla_fwd(params["attn"], L.rmsnorm(params["ln1"], x), cfg, ctx)
        return _ffn(params, x + h, cfg, ctx, aux)

    def decode(params, x, cfg, cache, pos, ctx):
        h, cache = MLA.mla_decode(params["attn"], L.rmsnorm(params["ln1"], x), cfg, cache, pos, ctx)
        x, _ = _ffn(params, x + h, cfg, ctx, 0.0)
        return x, cache

    def prefill(params, x, cfg, ctx, aux):
        h, (c_kv, k_rope) = MLA.mla_fwd(params["attn"], L.rmsnorm(params["ln1"], x), cfg, ctx)
        x, aux = _ffn(params, x + h, cfg, ctx, aux)
        return x, aux, {"c_kv": c_kv, "k_rope": k_rope}

    return dict(init=init, specs=specs, fwd=fwd, decode=decode, prefill=prefill, cache="mla")


def _mamba_block(moe: bool) -> dict[str, Any]:
    """The ``"mamba_moe"`` (``moe``) or ``"mamba"`` layer kind: a Mamba
    mixer, then the routed experts or a SwiGLU of ``d_ff`` (Jamba). Its
    decode state is recurrent: no one-pass prefill."""

    def init(generator, cfg, dtype):
        dev = L.init_device(generator)
        p = {
            "ln1": L.rmsnorm_init(cfg.d_model, dtype, dev),
            "mamba": SSM.mamba_init(generator, cfg, dtype),
            "ln2": L.rmsnorm_init(cfg.d_model, dtype, dev),
        }
        if moe:
            p["moe"] = L.moe_init(generator, cfg, dtype)
        else:
            p["mlp"] = L.swiglu_init(generator, cfg.d_model, cfg.d_ff, dtype)
        return p

    def specs(cfg):
        return {
            "ln1": {"scale": ("d_model",)},
            "mamba": SSM.mamba_specs(cfg),
            "ln2": {"scale": ("d_model",)},
            **({"moe": L.moe_specs(cfg)} if moe else {"mlp": L.swiglu_specs()}),
        }

    def fwd(params, x, cfg, ctx, aux):
        h, _ = SSM.mamba_fwd(params["mamba"], L.rmsnorm(params["ln1"], x), cfg, ctx)
        return _ffn(params, x + h, cfg, ctx, aux)

    def decode(params, x, cfg, cache, pos, ctx):
        h, cache = SSM.mamba_decode(params["mamba"], L.rmsnorm(params["ln1"], x), cfg, cache, ctx)
        x, _ = _ffn(params, x + h, cfg, ctx, 0.0)
        return x, cache

    return dict(init=init, specs=specs, fwd=fwd, decode=decode, prefill=None, cache="mamba")


def _rwkv_init(generator, cfg, dtype):
    dev = L.init_device(generator)
    return {
        "ln1": L.layernorm_init(cfg.d_model, dtype, dev),
        "tm": SSM.rwkv6_init(generator, cfg, dtype),
        "ln2": L.layernorm_init(cfg.d_model, dtype, dev),
        "cm": SSM.rwkv6_channel_mix_init(generator, cfg, dtype),
    }


def _rwkv_specs(cfg):
    return {
        "ln1": {"scale": ("d_model",), "bias": ("d_model",)},
        "tm": SSM.rwkv6_specs(cfg),
        "ln2": {"scale": ("d_model",), "bias": ("d_model",)},
        "cm": SSM.rwkv6_channel_mix_specs(),
    }


def _rwkv_fwd(params, x, cfg, ctx, aux):
    h, _ = SSM.rwkv6_time_mix(params["tm"], L.layernorm(params["ln1"], x), cfg, ctx)
    x = x + h
    h2, _ = SSM.rwkv6_channel_mix(params["cm"], L.layernorm(params["ln2"], x), ctx=ctx)
    return x + h2, aux


def _rwkv_decode(params, x, cfg, cache, pos, ctx):
    """One token through the RWKV layer: its ``wkv`` state and both
    token-shift rows are written into ``cache`` in place (on a mesh, each
    rank into the block it holds: the mixers return them placed as the
    cache is)."""
    h, (wkv, tm_prev) = SSM.rwkv6_time_mix(params["tm"], L.layernorm(params["ln1"], x), cfg, ctx,
                                           state=cache["wkv"], x_prev=cache["tm_prev"], return_state=True)
    x = x + h
    h2, cm_prev = SSM.rwkv6_channel_mix(params["cm"], L.layernorm(params["ln2"], x), x_prev=cache["cm_prev"],
                                        return_state=True, ctx=ctx)
    cache["wkv"].copy_(wkv)
    cache["tm_prev"].copy_(tm_prev)
    cache["cm_prev"].copy_(cm_prev)
    return x + h2, cache


_KINDS: dict[str, dict[str, Any]] = {
    "dense": dict(init=_dense_init, specs=_dense_specs, fwd=_dense_fwd, decode=_dense_decode,
                  prefill=_dense_prefill, cache="kv"),
    "moe": dict(init=_moe_init, specs=_moe_specs, fwd=_moe_fwd, decode=_moe_decode, prefill=_moe_prefill,
                cache="kv"),
    "mla_dense": _mla_block(False),
    "mla_moe": _mla_block(True),
    "mamba": _mamba_block(False),
    "mamba_moe": _mamba_block(True),
    "rwkv": dict(init=_rwkv_init, specs=_rwkv_specs, fwd=_rwkv_fwd, decode=_rwkv_decode, prefill=None,
                 cache="rwkv"),
}


def layer_pattern(cfg: ModelConfig) -> tuple[list[str], list[str], int]:
    """(prefix kinds, body period kinds, n_repeats)."""
    n = cfg.n_layers
    if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        return [], ["rwkv"], n
    if cfg.ssm is not None and cfg.ssm.kind == "mamba":
        period = cfg.ssm.attn_layer_period or 8
        kinds = []
        for i in range(period):
            is_attn = (i % period) == cfg.ssm.attn_layer_offset
            is_moe = cfg.moe is not None and (i % cfg.moe.layer_period) == cfg.moe.layer_offset
            if is_attn:
                kinds.append("moe" if is_moe else "dense")
            else:
                kinds.append("mamba_moe" if is_moe else "mamba")
        assert n % period == 0
        return [], kinds, n // period
    if cfg.mla is not None:
        fd = cfg.moe.first_dense if cfg.moe else 0
        return ["mla_dense"] * fd, ["mla_moe"], n - fd
    if cfg.moe is not None:
        return [], ["moe"], n
    return [], ["dense"], n


def _cache_init_for(kind: str, cfg, batch: int, s_max: int, dtype, device, layers: int | None = None):
    """Layer kind ``kind``'s decode cache, zeros, with a leading ``layers``
    axis when it is given (a stacked body). A recurrent state (Mamba, RWKV)
    has no positions: ``s_max`` does not size it."""
    c = _KINDS[kind]["cache"]
    if c == "kv":
        return _kv_cache_init(cfg, batch, s_max, dtype, device, layers)
    if c == "mla":
        return MLA.mla_cache_init(cfg, batch, s_max, dtype, device, layers)
    if c == "mamba":
        return SSM.mamba_state_init(cfg, batch, dtype, device, layers)
    if c == "rwkv":
        return SSM.rwkv6_state_init(cfg, batch, dtype, device, layers)
    raise KeyError(c)


def _cache_dims_for(kind: str):
    return {"kv": _kv_cache_dims, "mla": MLA.mla_cache_dims, "mamba": SSM.mamba_state_dims,
            "rwkv": SSM.rwkv6_state_dims}[_KINDS[kind]["cache"]]()


def _write_slot(cache_tree, content_tree, slot: int, mesh=None):
    """Write per-layer prefill content (1, L, ...) into row ``slot`` of the
    batched cache leaves (B, Smax, ...), positions [0, L), in place. A
    DTensor leaf is written on each rank's block (``shard_map``): the rank
    that holds row ``slot`` writes the positions of [0, L) it holds."""

    def write(leaf, content):
        if isinstance(leaf, DTensor):
            return _write_slot_meshed(leaf, content, slot, mesh)
        leaf[slot, : content.shape[1]] = content[0].to(leaf.dtype)
        return leaf

    return tree.map(write, cache_tree, content_tree)


def _write_slot_meshed(leaf, content, slot: int, mesh):
    spec = spec_of(leaf, mesh)
    b0, s0 = L._local_offsets(leaf)[:2]

    def region(loc, content):
        b, n = slot - b0, loc.shape[1]
        lo, hi = max(s0, 0), min(s0 + n, content.shape[1])
        if 0 <= b < loc.shape[0] and lo < hi:
            loc[b, lo - s0:hi - s0] = content[0, lo:hi].to(loc.dtype)
        return loc

    return shard_map(region, mesh, (spec, (None,) * content.ndim), spec)(leaf, content)


def _stacked_dims(dims):
    """A layer's logical-dims tree with the leading layer axis (``None``)
    added to every leaf."""
    if isinstance(dims, dict):
        return {k: _stacked_dims(v) for k, v in dims.items()}
    if not is_dims(dims):
        return tuple(_stacked_dims(v) for v in dims)
    return (None, *dims)


def _unstack(stacked) -> list:
    """Every layer's view of a pytree stacked over layers, each leaf split
    by one ``unbind`` (writes through a view reach the stacked tensor). Its
    backward writes the stacked gradient once, where indexing layer by layer
    would add a zero-filled stacked gradient for every layer."""
    leaves, treedef = tree.flatten(stacked)
    per_leaf = [a.unbind(0) for a in leaves]
    return [tree.unflatten(treedef, views) for views in zip(*per_leaf)]


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class Model(nn.Module):
    """The decoder-only, encoder-decoder or VLM model. Parameters are not registered on the
    module: they are a pytree passed to every call, as in the reference, so
    that the serving state, checkpoints and the coded guards see the
    reference's leaves."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        self.prefix, self.body, self.repeats = layer_pattern(cfg)
        self.is_encdec = cfg.encdec is not None
        self.is_vlm = cfg.vlm is not None

    # -- params ------------------------------------------------------------
    def init(self, generator: torch.Generator | None, shardings=None) -> dict:
        """Random parameters drawn from ``generator``, on its device (truncated
        normals at scale 0.02, norms at one); ``None`` gives the same pytree
        as ``meta`` tensors. The draws come in the order embed, lm_head, the
        prefix layers, the body, the encoder, MTP (the reference's key
        order), so a config without a prefix, an encoder or MTP draws what
        it drew before they were ported. Every leaf past
        ``layers.SLAB_ELEMENTS`` is drawn in slabs along its leading axis
        (``layers.DrawInto``), ``embed`` and ``lm_head`` too.

        With ``shardings`` (``train_loop.param_shardings`` on a mesh of
        ranks, the reference's ``jax.jit(model.init, out_shardings=ps)``),
        every rank walks the same draws, slab by slab, keeps the part of
        each slab that falls in its own block, and gets DTensors on those
        shardings: the same values as ``place(model.init(generator),
        shardings)``, with no rank ever holding more than its blocks and one
        slab."""
        cfg, dtype = self.cfg, self.dtype
        sh = (lambda key: None) if shardings is None else shardings.__getitem__
        V, d = cfg.vocab_padded, cfg.d_model
        params: dict[str, Any] = {
            "embed": _fill(generator, lambda g: L.truncnorm_init(g, (V, d), dtype), shardings=sh("embed")),
            "ln_f": _fill(generator, lambda g: L.rmsnorm_init(d, dtype, L.init_device(g)), shardings=sh("ln_f")),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = _fill(generator, lambda g: L.truncnorm_init(g, (d, V), dtype), shardings=sh("lm_head"))
        for i, kind in enumerate(self.prefix):
            params[f"prefix_{i}"] = _fill(generator, lambda g, k=kind: _KINDS[k]["init"](g, cfg, dtype),
                                          shardings=sh(f"prefix_{i}"))
        params["body"] = _fill(generator, self._layer_init, self.repeats, shardings=sh("body"))
        if self.is_encdec:
            params["encoder"] = self._encoder_init(generator, sh("encoder"))
        if cfg.mtp:
            params["mtp"] = _fill(generator, self._mtp_init, shardings=sh("mtp"))
        return params

    def _layer_init(self, generator) -> dict:
        return {f"b{j}": _KINDS[kind]["init"](generator, self.cfg, self.dtype) for j, kind in enumerate(self.body)}

    def _encoder_init(self, generator, shardings=None) -> dict:
        """The encoder: its layers (layernorm, attention, GELU MLP) stacked
        over ``n_enc_layers``, ``ln_post``, and one cross-attention block
        (layernorm, attention) a decoder layer, stacked over ``n_layers``.
        Drawn in that order: the layers, then the cross blocks."""
        cfg, dtype = self.cfg, self.dtype

        def layer(g):
            d = L.init_device(g)
            return {"ln1": L.layernorm_init(cfg.d_model, dtype, d), "attn": L.attention_init(g, cfg, dtype),
                    "ln2": L.layernorm_init(cfg.d_model, dtype, d),
                    "mlp": L.gelu_mlp_init(g, cfg.d_model, cfg.d_ff, dtype)}

        def cross(g):
            return {"ln": L.layernorm_init(cfg.d_model, dtype, L.init_device(g)),
                    "attn": L.attention_init(g, cfg, dtype)}

        sh = (lambda key: None) if shardings is None else shardings.__getitem__
        return {"layers": _fill(generator, layer, cfg.encdec.n_enc_layers, shardings=sh("layers")),
                "ln_post": _fill(generator, lambda g: L.layernorm_init(cfg.d_model, dtype, L.init_device(g)),
                                 shardings=sh("ln_post")),
                "cross": _fill(generator, cross, cfg.n_layers, shardings=sh("cross"))}

    def _mtp_init(self, generator) -> dict:
        """The multi-token-prediction head: two norms, a (2d, d) projection and
        one layer of the body's last kind (not stacked)."""
        cfg, dtype, dev = self.cfg, self.dtype, L.init_device(generator)
        return {
            "norm_h": L.rmsnorm_init(cfg.d_model, dtype, dev),
            "norm_e": L.rmsnorm_init(cfg.d_model, dtype, dev),
            "proj": L.truncnorm_init(generator, (2 * cfg.d_model, cfg.d_model), dtype),
            "block": _KINDS[self.body[-1]]["init"](generator, cfg, dtype),
        }

    def param_specs(self) -> dict:
        """The parameters' pytree as ``meta`` tensors (shapes and dtypes, no
        storage)."""
        return self.init(None)

    def param_dims(self) -> dict:
        """The parameters' logical dims (the reference's ``_dims_tree``):
        one tuple of names a leaf, ``None`` for the stacked layer axis."""
        cfg = self.cfg
        dims: dict[str, Any] = {
            "embed": ("vocab", "d_model"),
            "ln_f": {"scale": ("d_model",)},
        }
        if not cfg.tie_embeddings:
            dims["lm_head"] = ("d_model", "vocab")
        for i, kind in enumerate(self.prefix):
            dims[f"prefix_{i}"] = _KINDS[kind]["specs"](cfg)
        dims["body"] = {f"b{j}": _stacked_dims(_KINDS[kind]["specs"](cfg)) for j, kind in enumerate(self.body)}
        if self.is_encdec:
            ln = {"scale": ("d_model",), "bias": ("d_model",)}
            dims["encoder"] = {
                "layers": _stacked_dims({"ln1": ln, "attn": L.attention_specs(cfg), "ln2": ln,
                                         "mlp": L.gelu_mlp_specs()}),
                "ln_post": ln,
                "cross": _stacked_dims({"ln": ln, "attn": L.attention_specs(cfg)}),
            }
        if cfg.mtp:
            dims["mtp"] = {
                "norm_h": {"scale": ("d_model",)},
                "norm_e": {"scale": ("d_model",)},
                "proj": (None, "d_model"),
                "block": _KINDS[self.body[-1]]["specs"](cfg),
            }
        return dims

    # -- embedding / head ----------------------------------------------------
    def _embed(self, params, tokens):
        if isinstance(params["embed"], DTensor):
            # DTensor's strategy for a vocabulary-split lookup: each rank looks
            # up its rows, a masked partial sum, reduced here
            x = F.embedding(L.replicated_like(tokens, params["embed"]).long(), whole_grad(params["embed"]))
            return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p for p in x.placements])
        return params["embed"][tokens.long()]

    def _head(self, params, x):
        # the tied table's two gradients are summed: each leaves with no pending partial sum
        w = whole_grad(params["embed"]).T if self.cfg.tie_embeddings else params["lm_head"]
        logits = (L.rows(x) @ w).float()
        if self.cfg.vocab_padded > self.cfg.vocab_size:
            pad = torch.zeros((self.cfg.vocab_padded,), dtype=torch.float32, device=logits.device)
            pad[self.cfg.vocab_size:] = 1e30
            logits = logits - L.replicated_like(pad, logits)
        return logits

    # -- encoder (Whisper's stub frontend) ------------------------------------
    def _encode_frames(self, params, frames, ctx=L.NO_CTX):
        """frames: (B, F, d) precomputed stub embeddings → the encoder's
        output: sinusoidal positions added, then every encoder layer
        (bidirectional attention, no RoPE), then ``ln_post``."""
        cfg = self.cfg
        pe = L.replicated_like(_sinusoidal(frames.shape[1], cfg.d_model, frames.device), frames)
        x = ctx.cons(frames + pe.to(frames.dtype)[None], ("batch", "seq", "d_model"))
        enc = params["encoder"]
        for lp in _unstack(enc["layers"]):
            h, _ = L.attention_fwd(lp["attn"], L.layernorm(lp["ln1"], x), cfg, ctx, rope=False, causal=False)
            x = x + h
            x = x + L.gelu_mlp(lp["mlp"], L.layernorm(lp["ln2"], x), ctx)
        return L.layernorm(enc["ln_post"], x)

    def _cross_attn(self, cp, x, enc_out, ctx=L.NO_CTX):
        """The decoder's cross-attention onto the encoder's output: queries
        from ``layernorm(x)``, keys and values from ``enc_out`` (recomputed
        on every call), no RoPE, no mask. On a mesh the attention core runs
        on each rank's batch rows and heads (``layers._attention_core``),
        the S queries against all of the F frames."""
        cfg = self.cfg
        xn = L.rows(L.layernorm(cp["ln"], x))
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        enc_out = L.rows(enc_out)
        q = L._heads(xn @ cp["attn"]["wq"], H, hd)
        k = L._heads(enc_out @ cp["attn"]["wk"], Hkv, hd)
        v = L._heads(enc_out @ cp["attn"]["wv"], Hkv, hd)
        o = L._flat_heads(L._attention_core(ctx, q, k, v, causal=False))
        return ctx.cons(L.rows(o) @ cp["attn"]["wo"], ("batch", "seq", "d_model"))

    def _crosses(self, params) -> list | None:
        """The cross-attention blocks, one a body layer in ``_layers``'s
        order (repeat ``li``, body layer ``j`` at ``li * len(body) + j``), or
        ``None`` without an encoder."""
        return _unstack(params["encoder"]["cross"]) if self.is_encdec else None

    # -- trunk ----------------------------------------------------------------
    def _layers(self, params, cache=None):
        """Every layer in order, as (kind, its parameters, its cache or
        ``None``): the prefix, then the body's repeats (views of the stacked
        leaves)."""
        out = [(k, params[f"prefix_{i}"], None if cache is None else cache[f"prefix_{i}"])
               for i, k in enumerate(self.prefix)]
        blocks = _unstack(params["body"])
        caches = [None] * len(blocks) if cache is None else _unstack(cache["body"])
        for blk, bcache in zip(blocks, caches):
            out += [(k, blk[f"b{j}"], None if bcache is None else bcache[f"b{j}"]) for j, k in enumerate(self.body)]
        return out

    def _trunk(self, params, x, ctx, enc_out=None):
        """Full-seq forward through the prefix and the body, with the
        encoder-decoder's cross-attention after each body layer. Returns
        (x, aux). With ``remat="block"`` and autograd recording, each block
        keeps only its input for the backward pass and runs again there (the
        reference's ``jax.checkpoint`` of each block); the encoder-decoder's
        branch of the reference applies none."""
        cfg = self.cfg
        aux = L.replicated_like(torch.zeros((), dtype=torch.float32, device=x.device), x)
        remat = cfg.remat == "block" and torch.is_grad_enabled() and not self.is_encdec
        crosses = self._crosses(params)
        for i, (kind, p, _) in enumerate(self._layers(params)):
            fn = _KINDS[kind]["fwd"]
            if remat:
                x, aux = checkpoint(fn, p, x, cfg, ctx, aux, use_reentrant=False)
            else:
                x, aux = fn(p, x, cfg, ctx, aux)
            if crosses is not None and i >= len(self.prefix):
                x = x + self._cross_attn(crosses[i - len(self.prefix)], x, enc_out, ctx)
        return L.rmsnorm(params["ln_f"], x), aux

    # -- public forward --------------------------------------------------------
    def forward(self, params, batch, ctx=L.NO_CTX):
        """batch: {"tokens": (B,S) int, "frames" (encoder-decoder) or
        "patches" (VLM): (B, F or P, d)} → (logits (B,S,V_padded) f32, aux,
        h), over the text positions only."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"]).to(self.dtype)
        enc_out = None
        if self.is_encdec:
            frames = L.replicated_like(batch["frames"], params["embed"])  # a plain batch is every rank's whole
            enc_out = self._encode_frames(params, frames.to(self.dtype), ctx)
            x = x + L.replicated_like(_sinusoidal(x.shape[1], cfg.d_model, x.device), x).to(x.dtype)[None]
        if self.is_vlm:
            # the patches, then the text, each whole in the sequence first: their
            # positions are the reference's whatever splits the rules give them
            patches = L.replicated_like(batch["patches"], params["embed"])
            x = torch.cat([L.rows(patches.to(self.dtype)), L.rows(x)], dim=1)
        x = ctx.cons(x, ("batch", "seq", "d_model"))
        h, aux = self._trunk(params, x, ctx, enc_out)
        if self.is_vlm:
            h = L.rows(h)[:, batch["patches"].shape[1]:]
        logits = self._head(params, h)
        return logits, aux, h

    def loss(self, params, batch, ctx=L.NO_CTX):
        """Causal LM loss (+ 0.01 × the MoE aux term, zero in the dense family;
        + 0.3 × ``mtp_ce`` with MTP): position t predicts label t + 1; labels
        below 0 are masked out. MTP combines h_t with the embedding of token
        t + 1, runs one block of the body's last kind and predicts label t + 2."""
        cfg = self.cfg
        logits, aux, h = self.forward(params, batch, ctx)
        labels = batch["labels"]
        mask = (labels >= 0).float()
        ce = _xent(logits[:, :-1], labels[:, 1:], mask[:, 1:])
        metrics = {"ce": ce, "aux": aux}
        total = ce + 0.01 * aux
        if cfg.mtp:
            mtp = params["mtp"]
            # the lookup of every token, then the cut: the same rows, and on a mesh
            # DTensor's vocabulary-split lookup keeps a sequence split it can read
            emb_next = self._embed(params, batch["tokens"]).to(self.dtype)[:, 1:]
            hcomb = torch.cat([L.rmsnorm(mtp["norm_h"], h[:, :-1]), L.rmsnorm(mtp["norm_e"], emb_next)],
                              dim=-1) @ mtp["proj"]
            hcomb = ctx.cons(hcomb, ("batch", "seq", "d_model"))
            hm, _ = _KINDS[self.body[-1]]["fwd"](mtp["block"], hcomb, cfg, ctx,
                                                 torch.zeros((), dtype=torch.float32, device=h.device))
            mtp_ce = _xent(self._head(params, hm)[:, :-1], labels[:, 2:], mask[:, 2:])
            metrics["mtp_ce"] = mtp_ce
            total = total + 0.3 * mtp_ce
        metrics["loss"] = total
        return total, metrics

    # -- serving ---------------------------------------------------------------
    def init_cache(self, batch: int, s_max: int, device=None):
        """The decode cache, zeros, on ``device`` (``None``: the card):
        ``{"body": {"b0": ...}, "prefix_0": ..., ...}``, each body leaf
        stacked over the repeats ((n_repeats, batch, s_max, ...)), each
        prefix leaf (batch, s_max, ...); a KV layer holds ``k`` and ``v``, an
        MLA layer ``c_kv`` and ``k_rope``, a Mamba layer the tuple ``(h,
        conv_tail)`` and an RWKV layer ``wkv``, ``tm_prev`` and ``cm_prev``
        (recurrent states, no ``s_max`` axis); the encoder-decoder adds the
        encoder's output ``enc_out`` (batch, n_frames, d_model)."""
        cfg, dtype, device = self.cfg, self.dtype, resolve_device(device)
        cache: dict[str, Any] = {"body": {f"b{j}": _cache_init_for(k, cfg, batch, s_max, dtype, device, self.repeats)
                                          for j, k in enumerate(self.body)}}
        for i, kind in enumerate(self.prefix):
            cache[f"prefix_{i}"] = _cache_init_for(kind, cfg, batch, s_max, dtype, device)
        if self.is_encdec:
            cache["enc_out"] = torch.zeros((batch, cfg.encdec.n_frames, cfg.d_model), dtype=dtype, device=device)
        return cache

    def cache_dims(self):
        dims: dict[str, Any] = {"body": {f"b{j}": _stacked_dims(_cache_dims_for(k)) for j, k in enumerate(self.body)}}
        for i, kind in enumerate(self.prefix):
            dims[f"prefix_{i}"] = _cache_dims_for(kind)
        if self.is_encdec:
            dims["enc_out"] = ("batch", "frames", "d_model")
        return dims

    def decode_step(self, params, cache, tokens, pos, ctx=L.NO_CTX):
        """tokens: (B,1) int; pos: (B,) int → (logits (B,1,V), cache), the
        cache written in place at ``pos``. The encoder-decoder adds the
        sinusoidal position of ``pos`` and attends ``cache["enc_out"]``
        after each body layer; the VLM decodes text only (no patch prefix),
        as the reference does."""
        cfg = self.cfg
        x = ctx.cons(self._embed(params, tokens).to(self.dtype), ("batch", "seq", "d_model"))
        if self.is_encdec:
            x = x + L.replicated_like(_sinusoidal_at(pos, cfg.d_model), x).to(x.dtype)[:, None, :]
        crosses = self._crosses(params)
        for i, (kind, p, c) in enumerate(self._layers(params, cache)):
            x, _ = _KINDS[kind]["decode"](p, x, cfg, c, pos, ctx)
            if crosses is not None and i >= len(self.prefix):
                x = x + self._cross_attn(crosses[i - len(self.prefix)], x, cache["enc_out"], ctx)
        logits = self._head(params, L.rmsnorm(params["ln_f"], x))
        return logits, cache

    def prefill(self, params, batch, ctx=L.NO_CTX):
        """Run the full prompt, returning ``forward``'s outputs."""
        return self.forward(params, batch, ctx)

    @property
    def supports_prefill(self) -> bool:
        """True iff every layer kind can emit its cache rows from one
        full-sequence pass."""
        if self.is_encdec or self.is_vlm:
            return False
        return all(_KINDS[k].get("prefill") is not None for k in (*self.prefix, *self.body))

    def prefill_into_cache(self, params, cache, tokens, slot: int, ctx=L.NO_CTX):
        """One-pass prompt prefill into a decode-slot cache row.

        ``tokens``: (1, L) int, the prompt right-padded to a length bucket
        L ≤ Smax. Runs the full-sequence trunk once, writing every layer's
        cache content for positions [0, L) into row ``slot`` of the batched
        decode ``cache`` (in place), and returns ``(logits (1, L, V_padded),
        cache)``. Rows of the padded tail carry garbage K/V, which the decode
        path never attends (its mask is ``t <= pos`` and the per-token decode
        overwrites position p before attending it).
        """
        if not self.supports_prefill:
            raise NotImplementedError(
                f"{self.cfg.name}: one-pass prefill needs per-position cache "
                "rows in every layer (recurrent/enc-dec/VLM models refeed)"
            )
        cfg = self.cfg
        x = self._embed(params, tokens).to(self.dtype)
        x = ctx.cons(x, ("batch", "seq", "d_model"))
        aux = L.replicated_like(torch.zeros((), dtype=torch.float32, device=x.device), x)
        for kind, p, c in self._layers(params, cache):
            x, aux, content = _KINDS[kind]["prefill"](p, x, cfg, ctx, aux)
            _write_slot(c, content, slot, ctx.mesh)
        logits = self._head(params, L.rmsnorm(params["ln_f"], x))
        return logits, cache


def _fill(generator, make, repeats: int | None = None, shardings=None):
    """The tree ``make(generator)`` builds, its leaves allocated once and
    every drawn leaf drawn straight into place (in slabs where it is large,
    ``layers.DrawInto``); with ``repeats``, each leaf stacked over that many
    layers and filled layer by layer. The draws come in the order, and with
    the values, that calling ``make`` (once a layer, then stacking) would
    give, and the device never holds a leaf twice. With ``shardings`` (one
    ``NamedSharding`` a leaf of the stacked tree) each leaf is this rank's
    block of it, a DTensor on its sharding: every draw is made as in one
    process and the block's part of it kept."""
    rec = L.DrawInto(None)
    leaves, treedef = tree.flatten(make(rec))
    at = {id(t): i for i, t in enumerate(leaves)}
    order = [at[id(t)] for t in rec.drawn]
    lead = () if repeats is None else (repeats,)
    shapes = [(*lead, *t.shape) for t in leaves]
    if shardings is None:
        blocks = [((0,) * len(s), s) for s in shapes]
    else:
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        sh = tree.leaves(shardings)
        blocks = [tuple(reversed(compute_local_shape_and_global_offset(s, n.mesh.device_mesh, n.placements)))
                  for s, n in zip(shapes, sh, strict=True)]
    out = [torch.empty(tuple(n), dtype=t.dtype, device=L.init_device(generator)) for t, (_, n) in zip(leaves, blocks)]
    if generator is not None:
        for r in range(repeats or 1):
            dests = [L.Block(o if repeats is None else o[r], tuple(off[len(lead):]), tuple(s[len(lead):]))
                     for o, (off, _), s in zip(out, blocks, shapes)]
            made = tree.leaves(make(L.DrawInto(generator, [dests[i] for i in order])))
            for dest, t in zip(dests, made):
                if t is not dest.local:  # a leaf made without a draw (ones, zeros)
                    dest.take(t)
    if shardings is not None:
        out = [DTensor.from_local(o, n.mesh.device_mesh, n.placements, run_check=False, shape=torch.Size(s),
                                  stride=torch.empty(s, device="meta").stride())
               for o, n, s in zip(out, sh, shapes)]
    return tree.unflatten(treedef, out)


def _xent(logits, labels, mask):
    """Masked mean of float32 ``logsumexp - logit[label]`` (padded vocab
    columns carry -1e30 and drop out of the sum). A DTensor's vocabulary is
    gathered whole first (its other dims keep their split): DTensor's
    vocabulary-parallel gather fails on these shapes."""
    if isinstance(logits, DTensor):
        pl = [Replicate() if isinstance(p, Shard) and p.dim == logits.ndim - 1 else p for p in logits.placements]
        logits = logits.redistribute(logits.device_mesh, pl)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    nll = (lse - ll) * mask
    out = nll.sum() / torch.clamp_min(mask.sum(), 1.0)
    if isinstance(out, DTensor):  # summed over the mesh here, not as a pending partial sum
        out = out.redistribute(out.device_mesh, [Replicate()] * out.device_mesh.ndim)
    return out


@functools.lru_cache(maxsize=8)
def _sin_table(S: int, d: int) -> np.ndarray:
    """The (S, d) sinusoidal position table, built in float64 numpy and
    cast to float32, as the reference builds it."""
    pos = np.arange(S)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


def _sinusoidal(S: int, d: int, device) -> torch.Tensor:
    return torch.from_numpy(_sin_table(S, d)).to(device)


def _sinusoidal_at(pos, d: int) -> torch.Tensor:
    """The sinusoidal rows of positions ``pos`` (B,), computed in float32 on
    ``pos``'s device in the reference's order of operations."""
    i = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    ang = pos.float()[:, None] / (10000 ** (2 * i / d))[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def build_model(cfg: ModelConfig) -> Model:
    """The port's model for ``cfg``: every family of the registry."""
    return Model(cfg)
