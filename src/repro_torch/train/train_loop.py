"""Serve step factories — the serving half of the reference's train loop.

``make_decode_step`` and ``make_prefill_step`` build the eager callables the
serving engines run; the reference jit-compiles the same functions. The
training step (``make_train_step``) and the sharding functions wait for
ROADMAP queue A items 11 and 9.
"""

from __future__ import annotations

from ..models.layers import NO_CTX, Ctx


def make_ctx() -> Ctx:
    """The model context. One device only: the reference's ``(mesh, rules)``
    wait for the sharding substrate (ROADMAP queue A item 9)."""
    return NO_CTX


def make_decode_step(model):
    """``(params, cache, tokens (B, 1), pos (B,)) → (logits (B, 1, V_padded),
    cache)``, the cache written in place."""
    ctx = make_ctx()

    def decode_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos, ctx)

    return decode_step


def make_prefill_step(model, into_cache: bool = False):
    """Prefill step factory.

    ``into_cache=False``: ``(params, batch) → logits`` — full forward over
    the prompt, no cache.

    ``into_cache=True`` (serving): ``(params, cache, tokens (1, L), slot,
    plen) → (last_logits (1, V_padded), cache)`` — ONE forward pass writes
    the prompt's per-layer K/V into row ``slot`` of the batched decode cache
    (in place) and returns the logits of position ``plen - 1``, the first
    generated token's distribution.
    """
    ctx = make_ctx()

    if into_cache:

        def prefill_cache(params, cache, tokens, slot: int, plen: int):
            logits, cache = model.prefill_into_cache(params, cache, tokens, slot, ctx)
            return logits[:, max(int(plen) - 1, 0)], cache

        return prefill_cache

    def prefill(params, batch):
        logits, _aux, _ = model.forward(params, batch, ctx)
        return logits

    return prefill
