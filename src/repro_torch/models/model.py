"""Model assembly: the dense and MoE decoder-only LMs.

A model is a layer PATTERN: a non-repeated prefix (empty for the two
families ported) plus a repeated body period whose parameters (and decode
cache) are stacked over the repeats, so every body leaf has a leading
``n_layers`` axis — the reference's pytree, leaf for leaf, which is what the
coded-serving guard reads and what a checkpoint holds. The reference scans
the body with ``jax.lax.scan``; here a Python loop indexes the stacked
tensors.

Public surface (used by train/, serve/, launch/):
    build_model(cfg)        → Model
    model.init(generator)   → params (on the generator's device)
    model.param_specs()     → the params' pytree as ``meta`` tensors
    model.param_dims()      → the params' logical dims (``dist.sharding``)
    model.forward(params, batch, ctx)          → (logits, aux, hidden)
    model.loss(params, batch, ctx)             → (loss, {"ce", "aux", "loss"})
    model.init_cache(batch, s_max) / model.cache_dims()
    model.prefill(params, batch, ctx)          → forward
    model.decode_step(params, cache, tokens, pos, ctx) → (logits, cache)
    model.prefill_into_cache(params, cache, tokens, slot, ctx)
                            → (logits, cache)   # one-pass KV fill of a slot
    model.supports_prefill  → bool

The ``"dense"`` and ``"moe"`` layer kinds are ported; ``build_model``
refuses the other families, naming the ROADMAP item each waits for. Decode
and prefill write the cache in place and return it.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import tree
from ..configs.base import ModelConfig
from ..core.field import resolve_device
from . import layers as L

#: the ROADMAP.md queue A4 item each config feature that is not ported yet waits for
_NOT_PORTED = {"mla": "A4.2 (MLA)", "ssm": "A4.3 (Mamba, RWKV6)", "encdec": "A4.4 (encoder-decoder)",
               "vlm": "A4.4 (VLM)", "mtp": "A4.5 (MTP)"}


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


def _kv_cache_init(cfg, layers, batch, s_max, dtype, device):
    shape = (layers, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
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


_KINDS: dict[str, dict[str, Any]] = {
    "dense": dict(init=_dense_init, specs=_dense_specs, fwd=_dense_fwd, decode=_dense_decode,
                  prefill=_dense_prefill),
    "moe": dict(init=_moe_init, specs=_moe_specs, fwd=_moe_fwd, decode=_moe_decode, prefill=_moe_prefill),
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


def _write_slot(cache_tree, content_tree, slot: int):
    """Write per-layer prefill content (1, L, ...) into row ``slot`` of the
    batched cache leaves (B, Smax, ...), positions [0, L), in place."""

    def write(leaf, content):
        leaf[slot, : content.shape[1]] = content[0].to(leaf.dtype)
        return leaf

    return tree.map(write, cache_tree, content_tree)


def _stacked_dims(dims):
    """A layer's logical-dims tree with the leading layer axis (``None``)
    added to every leaf."""
    if isinstance(dims, dict):
        return {k: _stacked_dims(v) for k, v in dims.items()}
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
    """The dense or MoE decoder. Parameters are not registered on the module: they
    are a pytree passed to every call, as in the reference, so that the
    serving state, checkpoints and the coded guards see the reference's
    leaves."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        _, self.body, self.repeats = layer_pattern(cfg)  # no prefix in the families ported
        self.is_encdec = cfg.encdec is not None
        self.is_vlm = cfg.vlm is not None

    # -- params ------------------------------------------------------------
    def init(self, generator: torch.Generator | None) -> dict:
        """Random parameters drawn from ``generator``, on its device (truncated
        normals at scale 0.02, norms at one); ``None`` gives the same pytree
        as ``meta`` tensors."""
        cfg, dtype = self.cfg, self.dtype
        params: dict[str, Any] = {
            "embed": L.truncnorm_init(generator, (cfg.vocab_padded, cfg.d_model), dtype),
            "ln_f": L.rmsnorm_init(cfg.d_model, dtype, L.init_device(generator)),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.truncnorm_init(generator, (cfg.d_model, cfg.vocab_padded), dtype)
        params["body"] = self._init_body(generator)
        return params

    def _layer_init(self, generator) -> dict:
        return {f"b{j}": _KINDS[kind]["init"](generator, self.cfg, self.dtype) for j, kind in enumerate(self.body)}

    def _init_body(self, generator) -> dict:
        """The body's parameters, stacked over the repeats. Each stacked leaf
        is allocated once and filled layer by layer, every drawn leaf drawn
        straight into its layer's slot (in slabs where it is large,
        ``layers.DrawInto``): the draws come in the order, and with the
        values, that drawing whole layers and stacking them would give, and
        the device never holds a leaf twice."""
        rec = L.DrawInto(None)
        leaves, treedef = tree.flatten(self._layer_init(rec))
        at = {id(t): i for i, t in enumerate(leaves)}
        order = [at[id(t)] for t in rec.drawn]
        stacked = [torch.empty((self.repeats, *t.shape), dtype=t.dtype, device=L.init_device(generator))
                   for t in leaves]
        if generator is not None:
            for r in range(self.repeats):
                views = [s[r] for s in stacked]
                made = tree.leaves(self._layer_init(L.DrawInto(generator, [views[i] for i in order])))
                for view, t in zip(views, made):
                    if t is not view:  # a leaf made without a draw (ones, zeros)
                        view.copy_(t)
        return tree.unflatten(treedef, stacked)

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
        dims["body"] = {f"b{j}": _stacked_dims(_KINDS[kind]["specs"](cfg)) for j, kind in enumerate(self.body)}
        return dims

    # -- embedding / head ----------------------------------------------------
    def _embed(self, params, tokens):
        return params["embed"][tokens.long()]

    def _head(self, params, x):
        w = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        logits = (x @ w).float()
        if self.cfg.vocab_padded > self.cfg.vocab_size:
            pad = torch.zeros((self.cfg.vocab_padded,), dtype=torch.float32, device=logits.device)
            pad[self.cfg.vocab_size:] = 1e30
            logits = logits - pad
        return logits

    # -- trunk ----------------------------------------------------------------
    def _trunk(self, params, x, ctx):
        """Full-seq forward through the body. Returns (x, aux). With
        ``remat="block"`` and autograd recording, each block keeps only its
        input for the backward pass and runs again there (the reference's
        ``jax.checkpoint`` of each block)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        body_fns = [_KINDS[k]["fwd"] for k in self.body]
        remat = cfg.remat == "block" and torch.is_grad_enabled()
        for blk in _unstack(params["body"]):
            for j, fn in enumerate(body_fns):
                if remat:
                    x, aux = checkpoint(fn, blk[f"b{j}"], x, cfg, ctx, aux, use_reentrant=False)
                else:
                    x, aux = fn(blk[f"b{j}"], x, cfg, ctx, aux)
        return L.rmsnorm(params["ln_f"], x), aux

    # -- public forward --------------------------------------------------------
    def forward(self, params, batch, ctx=L.NO_CTX):
        """batch: {"tokens": (B,S) int} → (logits (B,S,V_padded) f32, aux, h)."""
        x = self._embed(params, batch["tokens"]).to(self.dtype)
        x = ctx.cons(x, ("batch", "seq", "d_model"))
        h, aux = self._trunk(params, x, ctx)
        logits = self._head(params, h)
        return logits, aux, h

    def loss(self, params, batch, ctx=L.NO_CTX):
        """Causal LM loss (+ 0.01 × the MoE aux term, zero in the dense family):
        position t predicts label t + 1; labels below 0 are masked out."""
        logits, aux, _ = self.forward(params, batch, ctx)
        labels = batch["labels"]
        mask = (labels >= 0).float()
        ce = _xent(logits[:, :-1], labels[:, 1:], mask[:, 1:])
        total = ce + 0.01 * aux
        return total, {"ce": ce, "aux": aux, "loss": total}

    # -- serving ---------------------------------------------------------------
    def init_cache(self, batch: int, s_max: int, device=None):
        """The decode cache, zeros, on ``device`` (``None``: the card):
        ``{"body": {"b0": {"k", "v"}}}`` with leaves (n_layers, batch, s_max,
        kv_heads, head_dim)."""
        cfg, dtype, device = self.cfg, self.dtype, resolve_device(device)
        return {"body": {f"b{j}": _kv_cache_init(cfg, self.repeats, batch, s_max, dtype, device)
                         for j, _k in enumerate(self.body)}}

    def cache_dims(self):
        return {"body": {f"b{j}": {k: (None, *d) for k, d in _kv_cache_dims().items()}
                         for j, _k in enumerate(self.body)}}

    def decode_step(self, params, cache, tokens, pos, ctx=L.NO_CTX):
        """tokens: (B,1) int; pos: (B,) int → (logits (B,1,V), cache), the
        cache written in place at ``pos``."""
        cfg = self.cfg
        x = self._embed(params, tokens).to(self.dtype)
        dec_fns = [_KINDS[k]["decode"] for k in self.body]
        for blk, bcache in zip(_unstack(params["body"]), _unstack(cache["body"])):
            for j, fn in enumerate(dec_fns):
                x, _ = fn(blk[f"b{j}"], x, cfg, bcache[f"b{j}"], pos, ctx)
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
        return all(_KINDS[k].get("prefill") is not None for k in self.body)

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
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        pf_fns = [_KINDS[k]["prefill"] for k in self.body]
        for blk, bcache in zip(_unstack(params["body"]), _unstack(cache["body"])):
            for j, fn in enumerate(pf_fns):
                x, aux, content = fn(blk[f"b{j}"], x, cfg, ctx, aux)
                _write_slot(bcache[f"b{j}"], content, slot)
        logits = self._head(params, L.rmsnorm(params["ln_f"], x))
        return logits, cache


def _xent(logits, labels, mask):
    """Masked mean of float32 ``logsumexp - logit[label]`` (padded vocab
    columns carry -1e30 and drop out of the sum)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    nll = (lse - ll) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1.0)


def build_model(cfg: ModelConfig) -> Model:
    """The port's model for ``cfg``. The dense and MoE families are ported
    (a config whose only extra is ``moe``): the others raise
    ``NotImplementedError`` naming the ROADMAP item they wait for."""
    what = [name for name, on in (("mla", cfg.mla is not None), ("ssm", cfg.ssm is not None),
                                  ("encdec", cfg.encdec is not None), ("vlm", cfg.vlm is not None),
                                  ("mtp", cfg.mtp)) if on]
    if what:
        raise NotImplementedError(
            f"{cfg.name}: the {', '.join(what)} layers are not ported yet; they wait for ROADMAP.md queue A4: "
            + ", ".join(dict.fromkeys(_NOT_PORTED[w] for w in what))
        )
    return Model(cfg)
