"""Train and serve step factories.

``make_train_step`` builds the eager train step (loss, gradients by
``torch.autograd``, AdamW); ``make_decode_step`` and ``make_prefill_step``
the callables the serving engines run. The reference jit-compiles the same
functions. Each takes the sharding rules (``dist.sharding.ShardingRules``,
as ``launch.profiles.rules_for`` picks them), whose flags the model reads;
a mesh, and the sharding functions (``param_shardings`` and the others),
wait for the device half of the sharding substrate (ROADMAP.md queue A3).

Gradient accumulation: ``accum > 1`` splits the batch's leading dim into
micro-batches and runs them one after the other (the reference's
``lax.scan``), summing float32 gradients.
"""

from __future__ import annotations

import torch

from .. import tree
from ..dist.sharding import ShardingRules
from ..models.layers import NO_CTX, Ctx
from . import optimizer as opt


def make_ctx(rules: ShardingRules | None = None) -> Ctx:
    """The model context: the rules, on one device (no mesh)."""
    return NO_CTX if rules is None else Ctx(rules=rules)


def make_train_step(model, opt_cfg: opt.OptConfig, accum: int = 1, rules: ShardingRules | None = None):
    """``(params, opt_state, batch) → (new_params, new_opt_state, metrics)``
    with ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr`` in ``metrics``,
    and ``mtp_ce`` for a model with MTP (``ce``, ``aux`` and ``mtp_ce`` of
    the last micro-batch, ``loss`` their mean). The
    inputs are left as they are. Gradients are taken with respect to the
    parameter pytree's own leaves, so the state keeps the reference's leaf
    order and stacked layout."""
    ctx = make_ctx(rules)

    def train_step(params, opt_state, batch):
        leaves, treedef = tree.flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        tracked = tree.unflatten(treedef, live)
        if accum == 1:
            loss, metrics = model.loss(tracked, batch, ctx)
            grads = torch.autograd.grad(loss, live)
        else:
            micro = {k: v.reshape((accum, v.shape[0] // accum) + tuple(v.shape[1:])) for k, v in batch.items()}
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
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


def make_decode_step(model, rules: ShardingRules | None = None):
    """``(params, cache, tokens (B, 1), pos (B,)) → (logits (B, 1, V_padded),
    cache)``, the cache written in place."""
    ctx = make_ctx(rules)

    def decode_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos, ctx)

    return decode_step


def make_prefill_step(model, into_cache: bool = False, rules: ShardingRules | None = None):
    """Prefill step factory.

    ``into_cache=False``: ``(params, batch) → logits`` — full forward over
    the prompt, no cache.

    ``into_cache=True`` (serving): ``(params, cache, tokens (1, L), slot,
    plen) → (last_logits (1, V_padded), cache)`` — ONE forward pass writes
    the prompt's per-layer K/V into row ``slot`` of the batched decode cache
    (in place) and returns the logits of position ``plen - 1``, the first
    generated token's distribution.
    """
    ctx = make_ctx(rules)

    if into_cache:

        def prefill_cache(params, cache, tokens, slot: int, plen: int):
            logits, cache = model.prefill_into_cache(params, cache, tokens, slot, ctx)
            return logits[:, max(int(plen) - 1, 0)], cache

        return prefill_cache

    def prefill(params, batch):
        logits, _aux, _ = model.forward(params, batch, ctx)
        return logits

    return prefill
