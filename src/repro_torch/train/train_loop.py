"""Train and serve step factories.

``make_train_step`` builds the eager train step (loss, gradients by
``torch.autograd``, AdamW); ``make_decode_step`` and ``make_prefill_step``
the callables the serving engines run. The reference jit-compiles the same
functions. Each takes the sharding rules (``dist.sharding.ShardingRules``,
as ``launch.profiles.rules_for`` picks them), whose flags the model reads,
and a mesh of ranks (``launch.mesh.RankMesh``): with one, the inputs are
DTensors placed by the sharding functions below (``param_shardings``,
``opt_state_shardings``, ``batch_shardings``, ``cache_shardings``, the
reference's, built from the model's logical dims in the reference's leaf
order) and the model's ``Ctx.cons`` redistributes activations to their
logical dims. The same step runs on one device or on the mesh; only the
shardings differ.

Gradient accumulation: ``accum > 1`` splits the batch's leading dim into
micro-batches and runs them one after the other (the reference's
``lax.scan``), summing float32 gradients.
"""

from __future__ import annotations

import torch

from .. import tree
from ..dist.sharding import NamedSharding, ShardingRules, is_dims, named_sharding
from ..models.inputs import batch_dims
from ..models.layers import NO_CTX, Ctx
from . import optimizer as opt


def make_ctx(mesh=None, rules: ShardingRules | None = None) -> Ctx:
    """The model context: the mesh and the rules (default rules on a mesh);
    ``NO_CTX`` when neither is given. Unlike the reference, rules without a
    mesh are kept: their flags steer the model on one device."""
    if mesh is None and rules is None:
        return NO_CTX
    return Ctx(mesh, rules if rules is not None or mesh is None else ShardingRules())


def make_train_step(model, opt_cfg: opt.OptConfig, accum: int = 1, rules: ShardingRules | None = None, *,
                    mesh=None):
    """``(params, opt_state, batch) → (new_params, new_opt_state, metrics)``
    with ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr`` in ``metrics``,
    and ``mtp_ce`` for a model with MTP (``ce``, ``aux`` and ``mtp_ce`` of
    the last micro-batch, ``loss`` their mean). The
    inputs are left as they are. Gradients are taken with respect to the
    parameter pytree's own leaves, so the state keeps the reference's leaf
    order and stacked layout. On a mesh every input is a DTensor and so is
    every output."""
    ctx = make_ctx(mesh, rules)

    def train_step(params, opt_state, batch):
        leaves, treedef = tree.flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        tracked = tree.unflatten(treedef, live)
        if accum == 1:
            loss, metrics = model.loss(tracked, batch, ctx)
            grads = torch.autograd.grad(loss, live)
        else:
            micro = {k: v.reshape((accum, v.shape[0] // accum) + tuple(v.shape[1:])) for k, v in batch.items()}
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            loss = 0.0
            for i in range(accum):
                l, metrics = model.loss(tracked, {k: v[i] for k, v in micro.items()}, ctx)
                for acc, g in zip(grads, torch.autograd.grad(l, live)):
                    acc.add_(g)
                loss = loss + l.detach()
            grads = [g / accum for g in grads]
            loss = loss / accum
        metrics = {k: v.detach() for k, v in metrics.items()}
        new_params, new_state, om = opt.apply_updates(opt_cfg, params, tree.unflatten(treedef, grads), opt_state)
        return new_params, new_state, {**metrics, **om, "loss": loss.detach()}

    return train_step


def make_decode_step(model, rules: ShardingRules | None = None, *, mesh=None):
    """``(params, cache, tokens (B, 1), pos (B,)) → (logits (B, 1, V_padded),
    cache)``, the cache written in place."""
    ctx = make_ctx(mesh, rules)

    def decode_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos, ctx)

    return decode_step


def make_prefill_step(model, into_cache: bool = False, rules: ShardingRules | None = None, *, mesh=None):
    """Prefill step factory.

    ``into_cache=False``: ``(params, batch) → logits`` — full forward over
    the prompt, no cache.

    ``into_cache=True`` (serving): ``(params, cache, tokens (1, L), slot,
    plen) → (last_logits (1, V_padded), cache)`` — ONE forward pass writes
    the prompt's per-layer K/V into row ``slot`` of the batched decode cache
    (in place) and returns the logits of position ``plen - 1``, the first
    generated token's distribution.
    """
    ctx = make_ctx(mesh, rules)

    if into_cache:

        def prefill_cache(params, cache, tokens, slot: int, plen: int):
            logits, cache = model.prefill_into_cache(params, cache, tokens, slot, ctx)
            return logits[:, max(int(plen) - 1, 0)], cache

        return prefill_cache

    def prefill(params, batch):
        logits, _aux, _ = model.forward(params, batch, ctx)
        return logits

    return prefill


# ---------------------------------------------------------------------------
# shardings (the dry run's and real placement's, as in the reference)
# ---------------------------------------------------------------------------


def _tree_shard(mesh, rules, shapes, dims):
    """One :class:`NamedSharding` a leaf of ``shapes``, from the logical dims
    tree ``dims`` (its leaves the dims tuples), read in the reference's leaf
    order; the result has the dims tree's structure."""
    flat_s = tree.leaves(shapes)
    flat_d = _dims_leaves(dims)
    if len(flat_s) != len(flat_d):
        raise ValueError(f"{len(flat_s)} leaves against {len(flat_d)} dims")
    out = iter([named_sharding(mesh, rules, d, tuple(s.shape)) for s, d in zip(flat_s, flat_d)])
    return _dims_map(lambda _: next(out), dims)


def _dims_leaves(dims) -> list:
    out: list = []
    _dims_map(out.append, dims)
    return out


def _dims_map(fn, dims):
    """``fn`` on every dims tuple of a dims tree, in the reference's leaf
    order (dict keys sorted)."""
    if is_dims(dims):
        return fn(dims)
    if isinstance(dims, dict):
        mapped = {k: _dims_map(fn, dims[k]) for k in sorted(dims)}
        return {k: mapped[k] for k in dims}
    return type(dims)(_dims_map(fn, d) for d in dims)


def param_shardings(model, mesh, rules: ShardingRules | None = None):
    """A :class:`NamedSharding` a parameter leaf."""
    return _tree_shard(mesh, rules, model.param_specs(), model.param_dims())


def opt_state_shardings(opt_cfg, model, mesh, rules: ShardingRules | None = None):
    """``m`` and ``v`` sharded as the parameters, ``step`` replicated."""
    pshard = param_shardings(model, mesh, rules)
    return {"m": pshard, "v": pshard, "step": NamedSharding(mesh, ())}


def batch_shardings(model, mesh, rules: ShardingRules | None = None, kind: str = "train"):
    """A :class:`NamedSharding` a batch field (``models.inputs.batch_dims``);
    no shape is known, so no divisibility check, as in the reference."""
    return {k: named_sharding(mesh, rules, d) for k, d in batch_dims(model.cfg, kind).items()}


def cache_shardings(model, mesh, rules: ShardingRules | None, cache_shapes):
    """A :class:`NamedSharding` a decode-cache leaf of ``cache_shapes``."""
    return _tree_shard(mesh, rules, cache_shapes, model.cache_dims())


def place(tree_, shardings):
    """Every leaf of ``tree_`` placed under its sharding (``shardings`` has
    the same structure; a :class:`NamedSharding` is a leaf of it): a full
    tensor keeps its block on each rank."""
    leaves, treedef = tree.flatten(tree_)
    return tree.unflatten(treedef, [s.place(t) for t, s in zip(leaves, tree.leaves(shardings), strict=True)])
