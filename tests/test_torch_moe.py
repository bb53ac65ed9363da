"""Differential tests of the port's MoE family (``repro_torch.models``:
``moe_block``, ``_segment_rank``, the ``"moe"`` layer kind, ``Model.init``'s
stacked fill) against the JAX package on the CPU.

The same numpy-seeded inputs go through ``repro.models`` and
``repro_torch.models`` (``device="cpu"``); parameters are carried across by
``repro_torch.convert.params_from_reference``, bfloat16 by its bits, which
also holds the MoE body's leaf order to the reference's. Tolerances:

* integer results (segment ranks, the router's expert choices, drops,
  greedy tokens, coded shards over GF(q)): equal;
* float32 ``moe_block``: ``ATOL_F32`` (1e-5) absolute; bfloat16: within
  ``BF16_SCALE`` (2^-6) of the largest reference value — the bf16 expert
  products round at other points in XLA and PyTorch;
* float32 model logits ``ATOL_LOGITS_F32`` (1e-4), bfloat16 logits
  ``ATOL_LOGITS_BF16`` (3e-2, absolute on logits below 1); the loss and the
  aux term ``ATOL_LOSS_F32`` (1e-5); gradients within ``GRAD_SCALE`` (1e-5)
  of each leaf's largest reference gradient — the tolerances of
  ``tests/test_torch_models.py`` and ``tests/test_torch_train.py``.

Within the port, the two dispatch forms (scatter, and gather under the
``moe_gather`` flag) give the same bits: with top-k ≤ 2 each token's
combine adds at most two float32 terms onto zero.

Capacity: in a prefill of T tokens an expert takes C = max(⌈T·k/E · 1.25⌉, 4)
(token, slot) pairs and drops the rest, so a prefill and a per-token refeed
need not agree (a decode step of B ≤ 4 slots drops nothing); prefill is held
against the reference's own prefill, padding included.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import smoke_config as r_smoke_config
from repro.dist.sharding import ShardingRules as RShardingRules
from repro.models import build_model as r_build_model
from repro.models import layers as RL
from repro.obs.metrics import MetricsRegistry as RMetricsRegistry
from repro.serve import CodedServeGuard as RCodedServeGuard
from repro.serve import ContinuousEngine as RContinuousEngine
from repro.serve import Engine as REngine
from repro.serve import LengthBand as RLengthBand
from repro.serve import poisson_trace as r_poisson_trace
from repro.train.elastic import CodedStateGuard as RStateGuard
from repro_torch import tree
from repro_torch.configs import get, smoke_config
from repro_torch.convert import params_from_reference, state_from_reference
from repro_torch.dist.sharding import ShardingRules
from repro_torch.models import build_model, layers as L
from repro_torch.models.model import _KINDS
from repro_torch.obs import MetricsRegistry
from repro_torch.serve import CodedServeGuard, ContinuousEngine, Engine, FaultInjector, LengthBand, poisson_trace
from repro_torch.train import CodedStateGuard, make_decode_step, make_prefill_step
from repro_torch.train.train_loop import make_ctx

ATOL_F32 = 1e-5
BF16_SCALE = 2.0 ** -6
ATOL_LOGITS_F32 = 1e-4
ATOL_LOGITS_BF16 = 3e-2
ATOL_LOSS_F32 = 1e-5
GRAD_SCALE = 1e-5

MOE_ARCHS = ["arctic-480b", "deepseek-v3-671b", "jamba-v0.1-52b"]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GATHER = ShardingRules(flags=["moe_gather"])
R_GATHER = RShardingRules(flags=["moe_gather"])


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def assert_close(port, ref, dtype: str, atol_f32: float = ATOL_F32):
    p, r = as_np(port), as_np(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    atol = atol_f32 if dtype == "float32" else BF16_SCALE * float(np.abs(r).max())
    np.testing.assert_allclose(p, r, rtol=0, atol=atol)


@functools.lru_cache(maxsize=8)
def moe_pair(arch: str, dtype: str, seed: int = 0):
    """(reference config, reference MoE params, port config, biased router)
    of ``arch``'s smoke MoE settings at ``dtype``: the biased router favours
    expert 0, so that tokens with a common offset overfill it."""
    rcfg = r_smoke_config(arch).replace(dtype=dtype)
    rp = RL.moe_init(jax.random.key(seed), rcfg, DTYPES[dtype][0])
    rng = np.random.default_rng(seed + 1)
    router = rng.normal(size=np.asarray(rp["router"]).shape).astype(np.float32) * 0.05
    router[:, 0] += 0.5
    return rcfg, rp, smoke_config(arch).replace(dtype=dtype), jnp.asarray(router)


def tokens_in(T: int, d: int, seed: int, offset: float) -> np.ndarray:
    """(1, T, d) activations: normal, plus ``offset`` in every feature (so
    that a router biased towards expert 0 sends every token there)."""
    return (np.random.default_rng(seed).normal(size=(1, T, d)) + offset).astype(np.float32)


def drops_of(eidx: torch.Tensor, cfg) -> int:
    """(token, slot) pairs past their expert's capacity."""
    T = eidx.shape[0]
    load = torch.bincount(eidx.reshape(-1), minlength=cfg.moe.n_experts)
    return int((load - L.moe_capacity(T, cfg)).clamp_min(0).sum())


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_segment_rank_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 5, size=int(rng.integers(1, 60))))
    same = np.concatenate([[0], (keys[1:] == keys[:-1]).astype(np.int32)])
    got = L._segment_rank(torch.from_numpy(same).long())
    want = RL._segment_rank(jnp.asarray(same, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int64


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T, drop", [(3, False), (24, True)])
def test_moe_block_both_forms_equal_the_reference(arch, dtype, T, drop):
    """Both dispatch forms at a token count that drops nothing and at one
    where the biased router overfills expert 0; the router's choices, the
    output and the aux term against the reference's scatter form and gather
    form; the two forms of the port equal each other bit for bit."""
    rcfg, rp, cfg, router = moe_pair(arch, dtype)
    if drop:
        rp = {**rp, "router": router}
    p = state_from_reference(jax.tree.map(np.asarray, rp), device="cpu")
    x = tokens_in(T, cfg.d_model, seed=T, offset=1.0 if drop else 0.0)
    jd, td = DTYPES[dtype]
    rx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    _, _, eidx = L.moe_route(p["router"], tx.reshape(T, -1), cfg)
    rlogits = rx.reshape(T, -1).astype(jnp.float32) @ rp["router"].astype(jnp.float32)
    if rcfg.moe.router_softmax_topk:
        _, r_eidx = jax.lax.top_k(jax.nn.softmax(rlogits, axis=-1), rcfg.moe.top_k)
    else:
        _, r_eidx = jax.lax.top_k(rlogits, rcfg.moe.top_k)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(r_eidx))
    assert (drops_of(eidx, cfg) > 0) == drop
    outs = {}
    for form, ctx, rctx in (("scatter", L.NO_CTX, RL.NO_CTX), ("gather", L.Ctx(rules=GATHER), RL.Ctx(rules=R_GATHER))):
        out, aux = L.moe_block(p, tx, cfg, ctx)
        rout, raux = RL.moe_block(rp, rx, rcfg, rctx)
        assert out.dtype == td and out.shape == tx.shape
        assert_close(out, rout, dtype)
        np.testing.assert_allclose(float(aux), float(raux), rtol=0, atol=ATOL_LOSS_F32)
        outs[form] = (out, aux)
    assert torch.equal(outs["scatter"][0], outs["gather"][0]) and torch.equal(outs["scatter"][1], outs["gather"][1])


def test_router_ties_take_the_lower_expert_first():
    """Equal router logits: the lower expert index first, as
    ``jax.lax.top_k`` orders ties."""
    cfg = smoke_config("arctic-480b").replace(dtype="float32")
    router = torch.zeros((cfg.d_model, cfg.moe.n_experts))
    router[:, 3] = 1.0
    xt = torch.ones((2, cfg.d_model))
    _, _, eidx = L.moe_route(router, xt, cfg)
    assert eidx.tolist() == [[3, 0], [3, 0]]
    _, r_eidx = jax.lax.top_k(jnp.asarray([[0.0, 0.0, 0.0, 1.0]] * 2), 2)
    assert np.asarray(r_eidx).tolist() == eidx.tolist()


def test_moe_capacity_of_arctic_prefill_buckets():
    """Arctic at full width: one slot's prefill at buckets 128, 256, 512 has
    4, 5 and 10 slots an expert; a decode tick of 4 slots has 4 (≥ T, no
    drop)."""
    cfg = get("arctic-480b")
    assert [L.moe_capacity(T, cfg) for T in (128, 256, 512, 4)] == [4, 5, 10, 4]


# ---------------------------------------------------------------------------
# the Arctic smoke model
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def arctic_pair(dtype: str = "float32", n_layers: int = 2, seed: int = 0):
    """(reference model, reference params, port model, port params) of the
    Arctic smoke config, the parameters carried across."""
    rcfg = r_smoke_config("arctic-480b").replace(dtype=dtype, n_layers=n_layers)
    rm = r_build_model(rcfg)
    rp = rm.init(jax.random.key(seed))
    m = build_model(smoke_config("arctic-480b").replace(dtype=dtype, n_layers=n_layers))
    return rm, rp, m, params_from_reference(jax.tree.map(np.asarray, rp), m, device="cpu")


def test_moe_params_carry_across_in_the_reference_leaf_order():
    rm, rp, m, p = arctic_pair("bfloat16")
    assert tree.structure(p) == tree.structure(m.param_specs()) == tree.structure(rp)
    body = [n for n in tree.flatten_with_names(p) if n.startswith("body/")]
    assert body == ["body/b0/attn/wk", "body/b0/attn/wo", "body/b0/attn/wq", "body/b0/attn/wv",
                    "body/b0/dense_mlp/w_down", "body/b0/dense_mlp/w_gate", "body/b0/dense_mlp/w_up",
                    "body/b0/ln1/scale", "body/b0/ln2/scale", "body/b0/moe/router", "body/b0/moe/w_down",
                    "body/b0/moe/w_gate", "body/b0/moe/w_up"]
    for got, want in zip(tree.leaves(p), jax.tree.leaves(rp)):
        assert tuple(got.shape) == want.shape and str(want.dtype) in str(got.dtype)
    assert p["body"]["b0"]["moe"]["router"].dtype == torch.float32
    assert p["body"]["b0"]["moe"]["w_gate"].shape == (2, 4, 64, 32)  # (n_layers, experts, d_model, expert_ff)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_arctic_forward_logits_and_aux(dtype):
    rm, rp, m, p = arctic_pair(dtype)
    toks = np.random.default_rng(0).integers(0, 503, size=(2, 37)).astype(np.int32)
    logits, aux, _ = m.forward(p, {"tokens": torch.from_numpy(toks)})
    rlogits, raux, _ = rm.forward(rp, {"tokens": jnp.asarray(toks)})
    atol = ATOL_LOGITS_F32 if dtype == "float32" else ATOL_LOGITS_BF16
    np.testing.assert_allclose(logits.numpy()[..., :503], np.asarray(rlogits)[..., :503], rtol=0, atol=atol)
    np.testing.assert_array_equal(logits.numpy()[..., 503:], np.asarray(rlogits)[..., 503:])
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(raux), rtol=0, atol=ATOL_LOSS_F32 if dtype == "float32" else 1e-3)


def test_arctic_loss_with_aux_and_gradients():
    rm, rp, m, p = arctic_pair("float32")
    toks = np.random.default_rng(3).integers(0, 503, size=(2, 16)).astype(np.int32)
    labels = toks.copy()
    labels[:, ::5] = -1
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (rl, rmet), rg = jax.value_and_grad(lambda pp: rm.loss(pp, rb), has_aux=True)(rp)
    leaves, treedef = tree.flatten(p)
    live = [t.detach().requires_grad_(True) for t in leaves]
    loss, metrics = m.loss(tree.unflatten(treedef, live), {"tokens": torch.from_numpy(toks),
                                                         "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(loss, live)
    metrics = {k: v.detach() for k, v in metrics.items()}
    for k in ("ce", "aux", "loss"):
        assert abs(float(metrics[k]) - float(rmet[k])) <= ATOL_LOSS_F32, k
    assert float(metrics["aux"]) > 0 and float(metrics["loss"]) == float(metrics["ce"] + 0.01 * metrics["aux"])
    for name, g, r in zip(tree.flatten_with_names(p), grads, jax.tree.leaves(rg)):
        r = as_np(r)
        np.testing.assert_allclose(as_np(g), r, rtol=0, atol=GRAD_SCALE * float(np.abs(r).max()), err_msg=name)
    assert all(float(g.abs().max()) > 0 for g in grads)  # every leaf, router and experts too, gets a gradient


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_arctic_decode_step_logits_and_cache(dtype):
    rm, rp, m, p = arctic_pair(dtype)
    B, smax = 3, 16
    rcache, cache = rm.init_cache(B, smax), m.init_cache(B, smax, device="cpu")
    assert tree.structure(cache) == tree.structure(rcache)
    toks = np.random.default_rng(1).integers(0, 503, size=(B, 6)).astype(np.int32)
    step = make_decode_step(m)
    atol = ATOL_LOGITS_F32 if dtype == "float32" else ATOL_LOGITS_BF16
    for t in range(6):
        pos = np.full((B,), t, np.int32)
        pos[2] = min(2 * t, smax - 1)
        lg, cache = step(p, cache, torch.from_numpy(toks[:, t:t + 1]), torch.from_numpy(pos))
        rlg, rcache = rm.decode_step(rp, rcache, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos))
        np.testing.assert_allclose(lg.numpy()[..., :503], np.asarray(rlg)[..., :503], rtol=0, atol=atol)
    for got, want in zip(tree.leaves(cache), jax.tree.leaves(rcache)):
        assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plen, bucket", [(5, 8), (13, 16), (30, 32)])
def test_arctic_prefill_into_cache_logits_and_slot(dtype, plen, bucket):
    """Prefill with the reference's padding, at buckets where capacity
    drops (token, slot) pairs (counted: the largest bucket drops some)."""
    rm, rp, m, p = arctic_pair(dtype)
    prompt = np.random.default_rng(plen).integers(1, 503, size=plen).astype(np.int32)
    tb = np.zeros((1, bucket), np.int32)
    tb[0, :plen] = prompt
    routed = []
    route = L.moe_route

    def counting(router, xt, cfg):
        out = route(router, xt, cfg)
        routed.append(drops_of(out[2], cfg))
        return out

    L.moe_route = counting
    try:
        logits, cache = m.prefill_into_cache(p, m.init_cache(3, 32, device="cpu"), torch.from_numpy(tb), 1)
    finally:
        L.moe_route = route
    assert len(routed) == 2 and (bucket < 32 or sum(routed) > 0), routed
    rlogits, rcache = rm.prefill_into_cache(rp, rm.init_cache(3, 32), jnp.asarray(tb), 1)
    atol = ATOL_LOGITS_F32 if dtype == "float32" else ATOL_LOGITS_BF16
    np.testing.assert_allclose(logits.numpy()[..., :503], np.asarray(rlogits)[..., :503], rtol=0, atol=atol)
    for got, want in zip(tree.leaves(cache), jax.tree.leaves(rcache)):
        assert_close(got, want, dtype)
        assert not got[:, [0, 2]].any()
    last, _ = make_prefill_step(m, into_cache=True, rules=GATHER)(p, m.init_cache(3, 32, device="cpu"),
                                                                  torch.from_numpy(tb), 1, plen)
    assert torch.equal(last, logits[:, plen - 1])  # the gather form: the same bits


# ---------------------------------------------------------------------------
# serving: greedy tokens and the guard
# ---------------------------------------------------------------------------

MIX = (LengthBand(2, 8, 0.5), LengthBand(9, 24, 0.5))
R_MIX = tuple(RLengthBand(b.lo, b.hi, b.weight) for b in MIX)
ENGINE_KW = dict(n_slots=3, max_len=40, buckets=(8, 16, 32), max_new_tokens=6)


def _toks(report) -> dict:
    return {r.id: tuple(r.tokens) for r in report.results}


@functools.lru_cache(maxsize=1)
def _reference_tokens():
    rm, rp, _, _ = arctic_pair()
    rtrace = r_poisson_trace(8, 2000.0, mix=R_MIX, max_new_tokens=6, vocab_size=503, seed=1)
    return _toks(RContinuousEngine(rm, rp, metrics=RMetricsRegistry(), **ENGINE_KW).serve(rtrace, greedy=True,
                                                                                            sync_every=2))


def _trace():
    return poisson_trace(8, 2000.0, mix=MIX, max_new_tokens=6, vocab_size=503, seed=1)


@pytest.mark.parametrize("rules", [None, GATHER], ids=["scatter", "gather"])
def test_continuous_greedy_tokens_equal_the_reference(rules):
    _, _, m, p = arctic_pair()
    got = ContinuousEngine(m, p, metrics=MetricsRegistry(), rules=rules, **ENGINE_KW).serve(_trace(), greedy=True,
                                                                                             sync_every=2)
    assert _toks(got) == _reference_tokens()


def test_fixed_engine_greedy_tokens_equal_the_reference():
    rm, rp, m, p = arctic_pair()
    prompts = [[5, 9, 2, 7, 1], [3, 3, 8], [11, 4, 6, 2, 9, 10, 1]]
    got = Engine(m, p, max_len=24, metrics=MetricsRegistry(), rules=GATHER).generate(prompts, max_new_tokens=5)
    want = REngine(rm, rp, max_len=24, metrics=RMetricsRegistry()).generate(prompts, max_new_tokens=5)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths, want.lengths)


def test_guarded_moe_serve_after_a_kill_equals_the_reference():
    _, _, m, p = arctic_pair()
    guard = CodedServeGuard(K=3, R=2, injector=FaultInjector(kills=((2, 1),)), device="cpu")
    got = ContinuousEngine(m, p, metrics=MetricsRegistry(), **ENGINE_KW).serve(_trace(), greedy=True, sync_every=2,
                                                                               guard=guard)
    assert got.recoveries == 1 and _toks(got) == _reference_tokens()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_guard_shards_of_the_moe_engine_state_equal_the_reference(dtype):
    """The reference MoE engine's (cache, state) after a prefill, carried
    across: the serving guard's coded shards equal the reference guard's bit
    for bit, and it recovers them."""
    rm, rp, _, _ = arctic_pair(dtype)
    cache = rm.init_cache(2, 16)
    tb = np.zeros((1, 8), np.int32)
    tb[0, :5] = [5, 9, 2, 7, 1]
    _, cache = rm.prefill_into_cache(rp, cache, jnp.asarray(tb), 1)
    state = {"last_tok": jnp.asarray([0, 17], jnp.int32), "pos": jnp.asarray([0, 5], jnp.int32),
             "active": jnp.asarray([False, True])}
    ref = RCodedServeGuard(K=3, R=2)
    ref.snapshot(cache, state, tick=0)
    port_cache, port_state = state_from_reference(jax.tree.map(np.asarray, (cache, state)), device="cpu")
    guard = CodedServeGuard(K=3, R=2, device="cpu")
    guard.snapshot(port_cache, port_state, tick=0)
    for j in range(5):
        np.testing.assert_array_equal(guard.group._mem[j], np.asarray(ref.group._mem[j]))
    back = guard.recover([0, 4])
    for a, b in zip(tree.leaves(back), tree.leaves((port_cache, port_state))):
        assert torch.equal(a, b) if a.dtype == torch.bool else \
            torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def test_coded_checkpoint_of_carried_moe_params_equals_the_reference():
    """A reference checkpoint of the MoE model's bf16 parameters carried
    across: the coded checkpoint's shards and parity equal the reference
    guard's bit for bit (the same leaves in the same order)."""
    _, rp, _, p = arctic_pair("bfloat16")
    ref = RStateGuard(K=4)
    ref.snapshot(rp, step=1)
    guard = CodedStateGuard(K=4, device="cpu")
    guard.snapshot(p, step=1)
    assert np.array_equal(guard._shards, ref._shards) and np.array_equal(guard._parity, ref._parity)


# ---------------------------------------------------------------------------
# Model.init: one stacked allocation, filled layer by layer
# ---------------------------------------------------------------------------


def test_dense_init_is_what_drawing_whole_layers_and_stacking_gives():
    """Qwen3's smoke weights from a seed are bit for bit what drawing each
    layer whole and stacking the layers gives (the init before the stacked
    fill)."""
    cfg = smoke_config("qwen3-1.7b").replace(n_layers=3)
    m = build_model(cfg)
    got = m.init(torch.Generator().manual_seed(11))
    g = torch.Generator().manual_seed(11)
    want = {"embed": L.truncnorm_init(g, (cfg.vocab_padded, cfg.d_model), torch.bfloat16),
            "ln_f": L.rmsnorm_init(cfg.d_model, torch.bfloat16, torch.device("cpu"))}
    layers = [{"b0": _KINDS["dense"]["init"](g, cfg, torch.bfloat16)} for _ in range(cfg.n_layers)]
    want["body"] = tree.map(lambda *xs: torch.stack(xs), *layers)
    assert tree.structure(got) == tree.structure(want)
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        assert a.dtype == b.dtype and a.is_contiguous() and torch.equal(a, b)


def test_moe_init_draws_large_leaves_in_slabs(monkeypatch):
    """A leaf past ``SLAB_ELEMENTS`` is drawn a few experts at a time into its
    slot: seeded, truncated at 2σ, the router at its own scale, norms at one;
    the meta tree has the same shapes and dtypes."""
    m = build_model(smoke_config("arctic-480b"))
    whole = m.init(torch.Generator().manual_seed(2))
    monkeypatch.setattr(L, "SLAB_ELEMENTS", 64 * 32)  # one expert's (d_model, expert_ff) a slab
    a, b = m.init(torch.Generator().manual_seed(2)), m.init(torch.Generator().manual_seed(2))
    assert all(torch.equal(x, y) for x, y in zip(tree.leaves(a), tree.leaves(b)))
    w = a["body"]["b0"]["moe"]["w_up"].float()
    assert not torch.equal(w, whole["body"]["b0"]["moe"]["w_up"].float())  # drawn otherwise
    assert float(w.abs().max()) <= 0.04 * (1 + 2.0 ** -7) and 0.01 < float(w.std()) < 0.02
    r = a["body"]["b0"]["moe"]["router"]
    assert r.dtype == torch.float32 and float(r.abs().max()) <= 0.012 and float(r.std()) > 0.003
    assert torch.equal(a["body"]["b0"]["ln2"]["scale"], torch.ones((2, 64), dtype=torch.bfloat16))
    assert [(tuple(x.shape), x.dtype) for x in tree.leaves(a)] == \
        [(tuple(x.shape), x.dtype) for x in tree.leaves(m.param_specs())]
    with pytest.raises(ValueError, match="into"):
        L.DrawInto(torch.Generator(), [torch.empty(3)]).draw((4,), torch.float32, 0.02)


def test_arctic_full_width_two_layers_bytes():
    """Arctic at full width, two layers, as meta tensors: 27,224,207,360 B a
    layer in bf16 (float32 router), 917,504,000 B of embed and lm_head."""
    m = build_model(get("arctic-480b").replace(n_layers=2))
    spec = m.param_specs()
    nbytes = lambda t: sum(x.numel() * x.element_size() for x in tree.leaves(t))  # noqa: E731
    assert spec["body"]["b0"]["moe"]["w_gate"].shape == (2, 128, 7168, 4864)
    assert nbytes(spec["body"]) == 2 * 27_224_207_360
    assert nbytes({k: spec[k] for k in ("embed", "lm_head")}) == 917_504_000
    assert all(t.device.type == "meta" for t in tree.leaves(spec))


def test_rules_reach_the_model_through_every_step():
    assert make_ctx(rules=GATHER).flag("moe_gather") and not make_ctx().flag("moe_gather")
    assert L.Ctx(rules=GATHER) == L.Ctx(rules=ShardingRules(flags=["moe_gather"]))
    _, _, m, p = arctic_pair()
    eng = ContinuousEngine(m, p, metrics=MetricsRegistry(), rules=GATHER, **ENGINE_KW)
    assert eng.rules is GATHER and L.NO_CTX.rules is None
