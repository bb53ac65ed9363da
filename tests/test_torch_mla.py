"""Differential tests of the port's MLA family (``repro_torch.models.mla``,
the ``"mla_dense"`` and ``"mla_moe"`` layer kinds, the layer prefix, MTP and
the MoE combine's fixed order) against the JAX package on the CPU.

The same numpy-seeded inputs go through ``repro.models`` and
``repro_torch.models`` (``device="cpu"``); parameters are carried across by
``repro_torch.convert.params_from_reference``, bfloat16 by its bits, which
also holds the pytree's leaf order (``body``, ``embed``, ``lm_head``,
``ln_f``, ``mtp``, ``prefix_0``, ...) to the reference's. DeepSeek-V3's smoke
config has one prefix layer and one body repeat; its ``n_layers=3`` variant
stacks a body of two. Tolerances, those of ``tests/test_torch_models.py``,
``tests/test_torch_moe.py`` and ``tests/test_torch_train.py``:

* integer results (router choices, greedy tokens, coded shards over GF(q),
  shapes, dims): equal;
* float32 modules ``ATOL_F32`` (1e-5) absolute; bfloat16 modules within
  ``BF16_SCALE`` (2^-6) of the largest reference value — XLA and PyTorch
  round the bf16 products (the absorbed decode's ``q_nope @ W_uk`` among
  them) at other points;
* float32 model logits ``ATOL_LOGITS_F32`` (1e-4), bfloat16 logits
  ``ATOL_LOGITS_BF16`` (3e-2); the loss, ``ce``, ``aux`` and ``mtp_ce``
  ``ATOL_LOSS_F32`` (1e-5); gradients
  within ``GRAD_SCALE`` (1e-5) of each leaf's largest reference gradient;
* decode against the teacher-forced forward, within the port: rtol and atol
  0.2, the reference's own ``test_decode_matches_forward_more_archs``.

The combine of ``moe_block`` adds each token's k float32 contributions onto
zero in ascending expert order: both dispatch forms give the same bits at
top-8, and at top-k ≤ 2 the bits of the scatter ``index_add`` it replaced.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as R_ARCHS
from repro.configs import smoke_config as r_smoke_config
from repro.dist.sharding import ShardingRules as RShardingRules
from repro.models import build_model as r_build_model
from repro.models import layers as RL
from repro.models import make_batch as r_make_batch
from repro.models import mla as RMLA
from repro.obs.metrics import MetricsRegistry as RMetricsRegistry
from repro.serve import CodedServeGuard as RCodedServeGuard
from repro.serve import ContinuousEngine as RContinuousEngine
from repro.serve import Request as RRequest
from repro.train import OptConfig as ROptConfig
from repro.train import init_state as r_init_state
from repro.train import make_train_step as r_make_train_step
from repro_torch import tree
from repro_torch.configs import get, smoke_config
from repro_torch.convert import params_from_reference, state_from_reference
from repro_torch.dist.sharding import ShardingRules
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.models import build_model, layers as L, mla as MLA
from repro_torch.models.model import _KINDS
from repro_torch.obs import MetricsRegistry
from repro_torch.serve import CodedServeGuard, ContinuousEngine, FaultInjector, Request
from repro_torch.serve.scheduler import bucket_for
from repro_torch.train import OptConfig, init_state, make_decode_step, make_prefill_step, make_train_step
from repro_torch.train.data import to_device

ATOL_F32 = 1e-5
BF16_SCALE = 2.0 ** -6
ATOL_LOGITS_F32 = 1e-4
ATOL_LOGITS_BF16 = 3e-2
ATOL_LOSS_F32 = 1e-5
GRAD_SCALE = 1e-5

ARCH = "deepseek-v3-671b"
V = 503  # the smoke vocabulary (padded to 512)
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


def assert_logits(port, ref, dtype: str):
    p, r = as_np(port), as_np(ref)
    atol = ATOL_LOGITS_F32 if dtype == "float32" else ATOL_LOGITS_BF16
    np.testing.assert_allclose(p[..., :V], r[..., :V], rtol=0, atol=atol)
    np.testing.assert_array_equal(p[..., V:], r[..., V:])  # the padded columns: -1e30


@functools.lru_cache(maxsize=8)
def pair(dtype: str = "float32", n_layers: int = 2, seed: int = 0):
    """(reference model, reference params, port model, port params) of
    DeepSeek-V3's smoke config, the parameters carried across."""
    rm = r_build_model(r_smoke_config(ARCH).replace(dtype=dtype, n_layers=n_layers))
    rp = rm.init(jax.random.key(seed))
    m = build_model(smoke_config(ARCH).replace(dtype=dtype, n_layers=n_layers))
    return rm, rp, m, params_from_reference(jax.tree.map(np.asarray, rp), m, device="cpu")


# ---------------------------------------------------------------------------
# the MLA module
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def mla_pair(dtype: str):
    rcfg = r_smoke_config(ARCH).replace(dtype=dtype)
    rp = RMLA.mla_init(jax.random.key(3), rcfg, DTYPES[dtype][0])
    return rcfg, rp, smoke_config(ARCH).replace(dtype=dtype), state_from_reference(jax.tree.map(np.asarray, rp),
                                                                                   device="cpu")


def test_mla_init_specs_and_cache_equal_the_reference():
    rcfg, rp, cfg, p = mla_pair("bfloat16")
    got = MLA.mla_init(None, cfg)
    assert tree.structure(got) == tree.structure(rp)
    for a, b in zip(tree.leaves(got), jax.tree.leaves(rp)):
        assert a.device.type == "meta" and tuple(a.shape) == b.shape and str(b.dtype) in str(a.dtype)
    assert MLA.mla_specs(cfg) == RMLA.mla_specs(rcfg)
    assert p["w_uk"].shape == (16, 4 * 16)  # (kv_lora_rank, H · qk_nope_head_dim), the reference's layout
    rc = RMLA.mla_cache_init(rcfg, 3, 10)
    c = MLA.mla_cache_init(cfg, 3, 10, device="cpu")
    assert tree.structure(c) == tree.structure(rc)
    for a, b in zip(tree.leaves(c), jax.tree.leaves(rc)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.bfloat16 and not a.any()
    assert MLA.mla_cache_init(cfg, 3, 10, torch.float32, "cpu", layers=2)["c_kv"].shape == (2, 3, 10, 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 13])
def test_mla_fwd_and_its_cache_rows_equal_the_reference(dtype, S):
    rcfg, rp, cfg, p = mla_pair(dtype)
    x = np.random.default_rng(S).normal(size=(2, S, cfg.d_model)).astype(np.float32)
    jd, td = DTYPES[dtype]
    y, (c_kv, k_rope) = MLA.mla_fwd(p, torch.from_numpy(x).to(td), cfg)
    ry, (rc_kv, rk_rope) = RMLA.mla_fwd(rp, jnp.asarray(x, jd), rcfg)
    assert y.dtype == td and c_kv.shape == (2, S, 16) and k_rope.shape == (2, S, 8)
    for got, want in ((y, ry), (c_kv, rc_kv), (k_rope, rk_rope)):
        assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_absorbed_decode_and_cache_equal_the_reference(dtype):
    """Six steps of the absorbed decode, slots at different positions (one
    revisits a position): the output and the cache it writes in place."""
    rcfg, rp, cfg, p = mla_pair(dtype)
    jd, td = DTYPES[dtype]
    B, smax = 3, 12
    rcache = RMLA.mla_cache_init(rcfg, B, smax, jd)
    cache = MLA.mla_cache_init(cfg, B, smax, td, "cpu")
    rng = np.random.default_rng(7)
    for t in range(6):
        x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        pos = np.array([t, 2 * t, min(t, 3)], np.int32)
        y, out = MLA.mla_decode(p, torch.from_numpy(x).to(td), cfg, cache, torch.from_numpy(pos))
        ry, rcache = RMLA.mla_decode(rp, jnp.asarray(x, jd), rcfg, rcache, jnp.asarray(pos))
        assert out is cache and y.shape == (B, 1, cfg.d_model)
        assert_close(y, ry, dtype)
    for got, want in zip(tree.leaves(cache), jax.tree.leaves(rcache)):
        assert_close(got, want, dtype)


# ---------------------------------------------------------------------------
# the model: prefix, body, MTP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_layers", [2, 3])
def test_params_and_dims_carry_across_in_the_reference_leaf_order(n_layers):
    rm, rp, m, p = pair("bfloat16", n_layers)
    assert (m.prefix, m.body, m.repeats) == (rm.prefix, rm.body, rm.repeats) == (["mla_dense"], ["mla_moe"],
                                                                                 n_layers - 1)
    assert tree.structure(p) == tree.structure(m.param_specs()) == tree.structure(rp)
    assert sorted(p) == sorted(rp) == ["body", "embed", "lm_head", "ln_f", "mtp", "prefix_0"]
    names = list(tree.flatten_with_names(p))
    assert [n.split("/")[0] for n in names] == sorted(n.split("/")[0] for n in names)
    for got, want in zip(tree.leaves(p), jax.tree.leaves(rp)):
        assert tuple(got.shape) == want.shape and str(want.dtype) in str(got.dtype)
    assert p["body"]["b0"]["moe"]["w_gate"].shape == (n_layers - 1, 4, 64, 32)
    assert p["prefix_0"]["mlp"]["w_up"].shape == (64, 96) and p["mtp"]["block"]["moe"]["w_up"].shape == (4, 64, 32)
    assert m.param_dims() == rm.param_specs()[1]
    assert m.cache_dims() == rm.cache_dims()


def test_full_width_param_specs_and_dims_equal_the_reference():
    """All 61 layers of DeepSeek-V3 as meta tensors: every leaf's shape and
    dtype, and the logical dims, equal the reference's ``param_specs``."""
    m = build_model(get(ARCH))
    rshapes, rdims = r_build_model(R_ARCHS[ARCH]).param_specs()
    spec = m.param_specs()
    assert tree.structure(spec) == tree.structure(rshapes)
    for (name, got), want in zip(tree.flatten_with_names(spec).items(), jax.tree.leaves(rshapes)):
        assert got.device.type == "meta" and tuple(got.shape) == want.shape and str(want.dtype) in str(got.dtype), name
    assert m.param_dims() == rdims
    assert spec["body"]["b0"]["moe"]["w_gate"].shape == (58, 256, 7168, 2048)
    assert [k for k in spec if k.startswith("prefix_")] == ["prefix_0", "prefix_1", "prefix_2"]


def test_full_width_four_layers_bytes():
    """The cut ``chip_smoke.py`` serves: 4 of 61 layers (the 3 dense prefix
    layers and one MoE layer) with MTP, 53,449,664,512 B of bf16 weights
    (float32 routers); the decode tick reads all but ``embed`` and ``mtp``;
    its cache at 4 slots × 1,024 positions is 18,874,368 B."""
    m = build_model(get(ARCH).replace(n_layers=4))
    spec = m.param_specs()
    by = lambda t: sum(x.numel() * x.element_size() for x in tree.leaves(t))  # noqa: E731
    assert by(spec["prefix_0"]) == 1_166_966_784 and by(spec["body"]) == 23_018_242_048
    assert by(spec["embed"]) == by(spec["lm_head"]) == 1_853_358_080 and by(spec["mtp"]) == 23_223_791_616
    assert by(spec) == 53_449_664_512
    assert by(spec) - by(spec["embed"]) - by(spec["mtp"]) == 28_372_514_816
    assert by(m.init_cache(4, 1024, device="meta")) == 18_874_368


@pytest.mark.parametrize("n_layers", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_and_aux(dtype, n_layers):
    rm, rp, m, p = pair(dtype, n_layers)
    toks = np.random.default_rng(0).integers(0, V, size=(2, 37)).astype(np.int32)
    logits, aux, h = m.forward(p, {"tokens": torch.from_numpy(toks)})
    rlogits, raux, rh = jax.jit(rm.forward)(rp, {"tokens": jnp.asarray(toks)})
    assert_logits(logits, rlogits, dtype)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(raux), rtol=0, atol=ATOL_LOSS_F32 if dtype == "float32" else 1e-3)


@pytest.mark.parametrize("n_layers", [2, 3])
def test_loss_with_mtp_and_gradients(n_layers):
    """``loss`` with ``mtp_ce`` (weight 0.3, labels shifted by two) and every
    leaf's gradient, the MTP head's and the prefix's too."""
    rm, rp, m, p = pair("float32", n_layers)
    toks = np.random.default_rng(3).integers(0, V, size=(2, 16)).astype(np.int32)
    labels = toks.copy()
    labels[:, ::5] = -1
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (rl, rmet), rg = jax.jit(jax.value_and_grad(lambda pp: rm.loss(pp, rb), has_aux=True))(rp)
    leaves, treedef = tree.flatten(p)
    live = [t.detach().requires_grad_(True) for t in leaves]
    loss, metrics = m.loss(tree.unflatten(treedef, live), {"tokens": torch.from_numpy(toks),
                                                         "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(loss, live)
    metrics = {k: float(v.detach()) for k, v in metrics.items()}
    assert sorted(metrics) == sorted(rmet) == ["aux", "ce", "loss", "mtp_ce"]
    for k in metrics:
        assert abs(metrics[k] - float(rmet[k])) <= ATOL_LOSS_F32, k
    assert metrics["mtp_ce"] > 0
    np.testing.assert_allclose(metrics["loss"], metrics["ce"] + 0.01 * metrics["aux"] + 0.3 * metrics["mtp_ce"],
                               rtol=1e-6)
    for name, g, r in zip(tree.flatten_with_names(p), grads, jax.tree.leaves(rg)):
        r = as_np(r)
        np.testing.assert_allclose(as_np(g), r, rtol=0, atol=GRAD_SCALE * float(np.abs(r).max()), err_msg=name)
    assert all(float(g.abs().max()) > 0 for g in grads)


def test_block_remat_gives_the_same_loss_and_gradients():
    """``remat="block"`` checkpoints the prefix blocks as it does the body's:
    the same loss and the same gradient bits."""
    _, rp, m, p = pair("float32", 3)
    mr = build_model(m.cfg.replace(remat="block"))
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, V, size=(2, 12)).astype(np.int32))
    out = []
    for model in (m, mr):
        leaves, treedef = tree.flatten(p)
        live = [t.detach().requires_grad_(True) for t in leaves]
        loss, _ = model.loss(tree.unflatten(treedef, live), {"tokens": toks, "labels": toks})
        out.append((loss.detach(), torch.autograd.grad(loss, live)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("n_layers", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_logits_and_cache(dtype, n_layers):
    """Token by token through ``decode_step`` (the prefix cache a top-level
    ``prefix_0`` leaf, the body's stacked), slots at different positions."""
    rm, rp, m, p = pair(dtype, n_layers)
    B, smax = 3, 16
    rcache, cache = rm.init_cache(B, smax), m.init_cache(B, smax, device="cpu")
    assert tree.structure(cache) == tree.structure(rcache) and sorted(cache) == ["body", "prefix_0"]
    assert cache["prefix_0"]["c_kv"].shape == (B, smax, 16) and cache["body"]["b0"]["c_kv"].shape[0] == n_layers - 1
    toks = np.random.default_rng(1).integers(0, V, size=(B, 6)).astype(np.int32)
    step, rstep = make_decode_step(m), jax.jit(rm.decode_step)
    for t in range(6):
        pos = np.full((B,), t, np.int32)
        pos[2] = min(2 * t, smax - 1)
        lg, cache = step(p, cache, torch.from_numpy(toks[:, t:t + 1]), torch.from_numpy(pos))
        rlg, rcache = rstep(rp, rcache, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos))
        assert_logits(lg, rlg, dtype)
    for got, want in zip(tree.leaves(cache), jax.tree.leaves(rcache)):
        assert_close(got, want, dtype)


def test_decode_matches_forward_more_archs():
    """The reference's ``test_decode_matches_forward_more_archs`` case for
    DeepSeek-V3: the absorbed decode reproduces the teacher-forced forward
    (its tolerance, 0.2), and both equal the reference's at float32."""
    from repro_torch.models import make_batch

    rm, rp, m, p = pair("bfloat16", 2)
    B, S = 2, 8
    batch = make_batch(m.cfg, B, S, seed=6, device="cpu")
    rbatch = r_make_batch(rm.cfg, B, S, seed=6)
    np.testing.assert_array_equal(batch["tokens"].numpy(), np.asarray(rbatch["tokens"]))
    full, _, _ = m.forward(p, batch)
    cache = m.init_cache(B, S, device="cpu")
    for t in range(S):
        lg, cache = m.decode_step(p, cache, batch["tokens"][:, t:t + 1], torch.full((B,), t, dtype=torch.int32))
        np.testing.assert_allclose(as_np(lg[:, 0, :V]), as_np(full[:, t, :V]), rtol=0.2, atol=0.2)
    rm32, rp32, m32, p32 = pair("float32", 2)
    full32, _, _ = m32.forward(p32, batch)
    rfull32, _, _ = rm32.forward(rp32, rbatch)
    assert_logits(full32, rfull32, "float32")


@pytest.mark.parametrize("dtype, n_layers", [("float32", 2), ("float32", 3), ("bfloat16", 2)])
@pytest.mark.parametrize("plen, bucket", [(5, 8), (30, 32)])
def test_prefill_into_cache_logits_and_slot(dtype, n_layers, plen, bucket):
    """Prefill with the reference's padding into slot 1: the logits and every
    cache leaf, the prefix's (not a view of a stacked tensor) too; the other
    slots stay zero; the gather form gives the same bits. The stacked body of
    two is held at float32: in bfloat16 its first MoE layer routes token 1
    of the 30-token prompt on a near-tie (the second and third router logits
    4.3e-4 apart), which the two packages' bf16 roundings break either way,
    so the second layer's cache row of that token differs beyond the bf16
    tolerance while the logits agree."""
    rm, rp, m, p = pair(dtype, n_layers)
    prompt = np.random.default_rng(plen).integers(1, V, size=plen).astype(np.int32)
    tb = np.zeros((1, bucket), np.int32)
    tb[0, :plen] = prompt
    logits, cache = m.prefill_into_cache(p, m.init_cache(3, 32, device="cpu"), torch.from_numpy(tb), 1)
    rlogits, rcache = jax.jit(rm.prefill_into_cache)(rp, rm.init_cache(3, 32), jnp.asarray(tb), 1)
    assert_logits(logits, rlogits, dtype)
    for got, want in zip(tree.leaves(cache), jax.tree.leaves(rcache)):
        assert_close(got, want, dtype)
        assert not got[..., [0, 2], :, :].any()
    assert cache["prefix_0"]["c_kv"][1, :plen].abs().sum() > 0
    last, _ = make_prefill_step(m, into_cache=True, rules=GATHER)(p, m.init_cache(3, 32, device="cpu"),
                                                                  torch.from_numpy(tb), 1, plen)
    assert torch.equal(last, logits[:, plen - 1])


# ---------------------------------------------------------------------------
# the MoE combine's fixed order
# ---------------------------------------------------------------------------


def index_add_combine(contrib, st, T, k):
    """The scatter form's combine before the fixed order: a float32
    ``index_add`` onto zero."""
    return torch.zeros((T, contrib.shape[1]), dtype=torch.float32).index_add(0, st, contrib.float())


@pytest.mark.parametrize("k", [1, 2, 8])
def test_combine_adds_in_ascending_expert_order(k):
    """Each token's k rows, expert-sorted, added onto float32 zero left to
    right; at k ≤ 2 the bits of ``index_add`` in any order of the rows,
    signed zeros included."""
    T, d, E = 9, 24, 16
    rng = np.random.default_rng(k)
    eidx = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    flat_t = np.repeat(np.arange(T), k)
    order = np.argsort(eidx.reshape(-1), kind="stable")
    st = torch.from_numpy(flat_t[order])
    vals = (rng.normal(size=(T * k, d)) * 10.0 ** rng.integers(-3, 4, size=(T * k, 1))).astype(np.float32)
    vals[rng.random(size=vals.shape) < 0.1] = -0.0
    contrib = torch.from_numpy(vals)
    got = L._combine(contrib, st, T, k)
    want = np.zeros((T, d), np.float32)
    for t in range(T):
        for row in np.flatnonzero(flat_t[order] == t):  # ascending expert order
            want[t] = want[t] + vals[row]
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    if k <= 2:
        for perm in (np.arange(T * k), rng.permutation(T * k)):
            p = torch.from_numpy(perm)
            ia = index_add_combine(contrib[p], st[p], T, k)
            assert np.array_equal(got.numpy().view(np.uint32), ia.numpy().view(np.uint32))


def top8_pair(dtype: str):
    """DeepSeek-V3's smoke MoE settings with 16 experts and top-8."""
    rcfg = r_smoke_config(ARCH).replace(dtype=dtype)
    rcfg = rcfg.replace(moe=dataclasses.replace(rcfg.moe, n_experts=16, top_k=8))
    cfg = smoke_config(ARCH).replace(dtype=dtype)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=16, top_k=8))
    rp = RL.moe_init(jax.random.key(5), rcfg, DTYPES[dtype][0])
    return rcfg, rp, cfg, state_from_reference(jax.tree.map(np.asarray, rp), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [4, 40])
def test_top8_combine_both_forms_bit_equal_and_near_the_reference(dtype, T):
    """Top-8 of 16 experts, with drops at T = 40: both dispatch forms and a
    second run give the same bits; each is within the float32 (bf16)
    tolerance of the reference's scatter and gather forms."""
    rcfg, rp, cfg, p = top8_pair(dtype)
    x = (np.random.default_rng(T).normal(size=(1, T, cfg.d_model)) + 0.5).astype(np.float32)
    jd, td = DTYPES[dtype]
    tx, rx = torch.from_numpy(x).to(td), jnp.asarray(x, jd)
    _, _, eidx = L.moe_route(p["router"], tx.reshape(T, -1), cfg)
    load = torch.bincount(eidx.reshape(-1), minlength=16)
    assert (int((load - L.moe_capacity(T, cfg)).clamp_min(0).sum()) > 0) == (T == 40)
    outs = []
    for ctx, rctx in ((L.NO_CTX, RL.NO_CTX), (L.Ctx(rules=GATHER), RL.Ctx(rules=R_GATHER)), (L.NO_CTX, RL.NO_CTX)):
        out, aux = L.moe_block(p, tx, cfg, ctx)
        rout, raux = jax.jit(lambda pp, xx, c=rctx: RL.moe_block(pp, xx, rcfg, c))(rp, rx)
        assert_close(out, rout, dtype)
        np.testing.assert_allclose(float(aux), float(raux), rtol=0, atol=ATOL_LOSS_F32)
        outs.append(out)
    assert all(torch.equal(o.view(torch.int16) if dtype == "bfloat16" else o.view(torch.int32),
                           outs[0].view(torch.int16) if dtype == "bfloat16" else outs[0].view(torch.int32))
               for o in outs[1:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_arctic_smoke_logits_unchanged_by_the_fixed_order(dtype, monkeypatch):
    """Arctic (top-2): the forward, decode and prefill logits with the fixed
    order are bit for bit those of the ``index_add`` combine."""
    cfg = smoke_config("arctic-480b").replace(dtype=dtype)
    m = build_model(cfg)
    p = m.init(torch.Generator().manual_seed(8))
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, V, size=(2, 30)).astype(np.int32))

    def run():
        fwd = m.forward(p, {"tokens": toks})[0]
        pf, cache = m.prefill_into_cache(p, m.init_cache(2, 40, device="cpu"), toks[:1], 0)
        dec, _ = m.decode_step(p, cache, toks[:, :1], torch.tensor([30, 0], dtype=torch.int32))
        return fwd, pf, dec

    new = run()
    monkeypatch.setattr(L, "_combine", index_add_combine)
    old = run()
    assert all(torch.equal(a, b) for a, b in zip(new, old))


# ---------------------------------------------------------------------------
# init: the prefix and MTP drawn into place
# ---------------------------------------------------------------------------


def test_init_is_what_drawing_each_part_whole_gives():
    """DeepSeek-V3's smoke weights from a seed are bit for bit what drawing
    embed, lm_head, the prefix layer, each body layer (stacked) and the MTP
    head whole gives, in that order."""
    cfg = smoke_config(ARCH).replace(n_layers=3)
    m = build_model(cfg)
    got = m.init(torch.Generator().manual_seed(11))
    g, bf = torch.Generator().manual_seed(11), torch.bfloat16
    want = {"embed": L.truncnorm_init(g, (cfg.vocab_padded, cfg.d_model), bf),
            "ln_f": L.rmsnorm_init(cfg.d_model, bf, torch.device("cpu")),
            "lm_head": L.truncnorm_init(g, (cfg.d_model, cfg.vocab_padded), bf),
            "prefix_0": _KINDS["mla_dense"]["init"](g, cfg, bf)}
    want["body"] = tree.map(lambda *xs: torch.stack(xs), *[{"b0": _KINDS["mla_moe"]["init"](g, cfg, bf)}
                                                          for _ in range(2)])
    want["mtp"] = m._mtp_init(g)
    assert tree.structure(got) == tree.structure(want)
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        assert a.dtype == b.dtype and a.is_contiguous() and torch.equal(a, b)


def test_mtp_expert_leaf_is_drawn_in_slabs(monkeypatch):
    """MTP's unstacked expert leaf past ``SLAB_ELEMENTS`` is drawn a few
    experts at a time into its one allocation: seeded, truncated at 2σ."""
    m = build_model(smoke_config(ARCH))
    monkeypatch.setattr(L, "SLAB_ELEMENTS", 64 * 32)  # one expert's (d_model, expert_ff) a slab
    drawn = []
    draw = L.DrawInto.draw

    def spy(self, shape, dtype, scale):
        out = draw(self, shape, dtype, scale)
        drawn.append((tuple(shape), out.data_ptr()))
        return out

    monkeypatch.setattr(L.DrawInto, "draw", spy)
    a = m.init(torch.Generator().manual_seed(2))
    b = m.init(torch.Generator().manual_seed(2))
    assert all(torch.equal(x, y) for x, y in zip(tree.leaves(a), tree.leaves(b)))
    w = a["mtp"]["block"]["moe"]["w_gate"]
    assert (tuple(w.shape), w.data_ptr()) in drawn
    assert float(w.float().abs().max()) <= 0.04 * (1 + 2.0 ** -7) and 0.01 < float(w.float().std()) < 0.02
    assert torch.equal(a["mtp"]["norm_h"]["scale"], torch.ones(64, dtype=torch.bfloat16))
    assert [(tuple(x.shape), x.dtype) for x in tree.leaves(a)] == \
        [(tuple(x.shape), x.dtype) for x in tree.leaves(m.param_specs())]


# ---------------------------------------------------------------------------
# serving, the guard, a train step and the launchers
# ---------------------------------------------------------------------------

PROMPTS = [[5, 9, 2, 7, 1], [3, 3, 8], [11, 4, 6, 2, 9, 10, 1], [2], [7, 5, 5, 5, 1, 2]]
ENGINE_KW = dict(n_slots=2, max_len=32, buckets=(8, 16), max_new_tokens=8)


def _toks(report) -> list:
    return [list(r.tokens) for r in report.results]


@functools.lru_cache(maxsize=1)
def _reference_tokens():
    """The reference's continuous engine on ``tests/test_serve.py``'s
    DeepSeek case (five staggered prompts through two slots), float32."""
    rm, rp, _, _ = pair("float32", 2)
    reqs = [RRequest(id=f"r{i}", prompt=q, max_new_tokens=6) for i, q in enumerate(PROMPTS)]
    return _toks(RContinuousEngine(rm, rp, metrics=RMetricsRegistry(), **ENGINE_KW).serve(reqs, greedy=True,
                                                                                          sync_every=2))


def _requests():
    return [Request(id=f"r{i}", prompt=q, max_new_tokens=6) for i, q in enumerate(PROMPTS)]


@pytest.mark.parametrize("rules", [None, GATHER], ids=["scatter", "gather"])
def test_continuous_greedy_tokens_equal_the_reference(rules):
    _, _, m, p = pair("float32", 2)
    got = ContinuousEngine(m, p, metrics=MetricsRegistry(), rules=rules, **ENGINE_KW).serve(_requests(), greedy=True,
                                                                                             sync_every=2)
    assert _toks(got) == _reference_tokens()
    assert all(r.gen_len == 6 for r in got.results)


def test_continuous_matches_one_at_a_time():
    """The reference's invariant within the port: each prompt alone through
    the prefill and decode steps gives the engine's tokens."""
    _, _, m, p = pair("float32", 2)
    pf, dec = make_prefill_step(m, into_cache=True), make_decode_step(m)
    want = []
    for q in PROMPTS:
        b = bucket_for(len(q), (8, 16))
        tb = np.zeros((1, b), np.int32)
        tb[0, : len(q)] = q
        last, cache = pf(p, m.init_cache(1, 32, device="cpu"), torch.from_numpy(tb), 0, len(q))
        toks = [int(last[0, :V].argmax())]
        for i in range(5):
            lg, cache = dec(p, cache, torch.tensor([[toks[-1]]], dtype=torch.int32),
                            torch.tensor([len(q) + i], dtype=torch.int32))
            toks.append(int(lg[0, 0, :V].argmax()))
        want.append(q + toks)
    assert want == _reference_tokens()


def test_guarded_serve_after_a_kill_equals_the_reference():
    _, _, m, p = pair("float32", 2)
    guard = CodedServeGuard(K=3, R=2, injector=FaultInjector(kills=((2, 1),)), device="cpu")
    got = ContinuousEngine(m, p, metrics=MetricsRegistry(), **ENGINE_KW).serve(_requests(), greedy=True, sync_every=2,
                                                                               guard=guard)
    assert got.recoveries == 1 and _toks(got) == _reference_tokens()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_guard_shards_of_the_mla_engine_state_equal_the_reference(dtype):
    """The reference engine's (cache, state) after a prefill, carried across
    (prefix cache leaves beside the stacked body's): the serving guard's
    coded shards equal the reference guard's bit for bit, and it recovers
    them."""
    rm, rp, _, _ = pair(dtype, 3)
    cache = rm.init_cache(2, 16)
    tb = np.zeros((1, 8), np.int32)
    tb[0, :5] = [5, 9, 2, 7, 1]
    _, cache = jax.jit(rm.prefill_into_cache)(rp, cache, jnp.asarray(tb), 1)
    state = {"last_tok": jnp.asarray([0, 17], jnp.int32), "pos": jnp.asarray([0, 5], jnp.int32),
             "active": jnp.asarray([False, True])}
    ref = RCodedServeGuard(K=3, R=2)
    ref.snapshot(cache, state, tick=0)
    port_cache, port_state = state_from_reference(jax.tree.map(np.asarray, (cache, state)), device="cpu")
    assert sorted(port_cache) == ["body", "prefix_0"]
    guard = CodedServeGuard(K=3, R=2, device="cpu")
    guard.snapshot(port_cache, port_state, tick=0)
    for j in range(5):
        np.testing.assert_array_equal(guard.group._mem[j], np.asarray(ref.group._mem[j]))
    back = guard.recover([0, 4])
    for a, b in zip(tree.leaves(back), tree.leaves((port_cache, port_state))):
        assert torch.equal(a, b) if a.dtype == torch.bool else \
            torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def test_train_step_with_mtp_equals_the_reference():
    """One AdamW step of the float32 smoke config (prefix, stacked body,
    MTP): ``mtp_ce`` among the metrics, the losses within ``ATOL_LOSS_F32``,
    the update within ``tests/test_torch_train.py``'s step bound (float32:
    1e-6 but for at most 2 % of a leaf, those within 2 · lr · 1.05)."""
    rm, rp, m, p = pair("float32", 3, seed=1)
    cfg, rcfg = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10), ROptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    b = r_make_batch(rm.cfg, 4, 16, seed=5)
    rb = {k: jnp.asarray(v) for k, v in b.items()}
    want = jax.jit(r_make_train_step(rm, rcfg))(rp, r_init_state(rcfg, rp), rb)
    got = make_train_step(m, cfg)(p, init_state(cfg, p), to_device({k: np.array(v) for k, v in b.items()}, "cpu"))
    assert sorted(got[2]) == sorted(want[2]) == ["aux", "ce", "grad_norm", "loss", "lr", "mtp_ce"]
    for k in ("loss", "ce", "mtp_ce"):
        assert abs(float(got[2][k]) - float(want[2][k])) <= ATOL_LOSS_F32, k
    lr = float(got[2]["lr"])
    for name, a, r in zip(tree.flatten_with_names(p), tree.leaves(got[0]), jax.tree.leaves(want[0])):
        tight = 1e-6
        d = np.abs(as_np(a) - as_np(r))
        assert (d <= 2 * lr * 1.05 + tight).all(), name
        assert (d > tight).mean() <= 0.02, name


def test_launchers_serve_and_train_deepseek_on_the_cpu(capsys):
    out = serve_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--prompts", "1,2,3;4,5", "--max-new", "6",
                      "--max-len", "32", "--coded", "3,2", "--kill", "2:0"])
    text = capsys.readouterr().out
    assert [len(r.tokens) for r in out.results] == [9, 8] and out.recoveries == 1
    assert "prefill graphs, on cpu" in text and "1 hosts recovered from" in text
    res = train_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2", "--seq", "16", "--steps", "2",
                      "--coded-every", "1"])
    text = capsys.readouterr().out
    assert [sorted(h) for h in res["history"]] == [["grad_norm", "loss", "mtp_ce", "s", "step"]] * 2
    assert all(np.isfinite(h["mtp_ce"]) and h["mtp_ce"] > 0 for h in res["history"])
    assert "mtp_ce" in text and "done: 2 steps" in text
    assert sorted(res["state"]["params"]) == ["body", "embed", "lm_head", "ln_f", "mtp", "prefix_0"]
