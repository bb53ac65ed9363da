"""Differential tests of the port's training slice (``Model.loss``,
``repro_torch.train.optimizer``, ``.data``, ``make_train_step``, the resumes
and ``convert.train_state_from_reference``) against the JAX package on the
CPU.

The same numpy-seeded inputs go through ``repro`` and ``repro_torch``
(``device="cpu"``); parameters and train states are carried across by
``repro_torch.convert.params_from_reference`` and
``train_state_from_reference``, bfloat16 by its bits. Data, state layouts,
checkpoints and resumes are held bit for bit. The arithmetic of a loss, a
gradient and an update is float, and XLA and PyTorch sum and round in other
orders, so each float comparison states its tolerance:

* loss: float32 within ``ATOL_LOSS_F32`` (1e-5; measured 1.4e-6), bfloat16
  within ``ATOL_LOSS_BF16`` (5e-4; measured 1.9e-5);
* gradients, leaf by leaf in pytree order: within ``GRAD_SCALE[dtype]`` of the
  leaf's largest reference gradient — float32 1e-5 (measured 1e-6), bfloat16
  2^-5, eight bf16 ulps (measured 8.6e-3: the packages round bf16
  activations at different points);
* schedule and global norm: float32 relative ``RTOL_F32`` (1e-5); AdamW on
  the same gradients: each element within ``RTOL_F32`` of the leaf's
  largest value (the clip scale differs in its last bits; float32 moments
  measured 1e-7 of it),
  plus, for bfloat16 moments and parameters, one bf16 ulp of the value
  (``BF16_ULP``, 2^-7 relative: one ulp is 2^-8 to 2^-7 of a value; where
  the float32 values straddle a rounding boundary);
* parameters after a train step from zero moments: AdamW's first step moves
  each element by lr · (mhat / (sqrt(vhat) + eps) + decay), and
  mhat / sqrt(vhat) is sign(g), so an element whose gradient lies within
  float error of 0 may move 2 · lr apart between the packages. Every element
  lies within ``2 * lr * STEP_SLACK`` (1.05) plus one ulp of its parameter,
  and at most ``STEP_FRACTION`` (2 %) of a leaf's elements lie beyond the
  tight bound (float32 1e-6; bfloat16 one ulp of the value) — measured at
  most 0.4 %.
"""

import gc
import os
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import smoke_config as r_smoke_config
from repro.models import build_model as r_build_model
from repro.models import make_batch as r_make_batch
from repro.train import OptConfig as ROptConfig
from repro.train import SyntheticLM as RSyntheticLM
from repro.train import init_state as r_init_state
from repro.train import make_train_step as r_make_train_step
from repro.train import save_checkpoint as r_save_checkpoint
from repro.train import optimizer as r_opt
from repro.train.data import DataConfig as RDataConfig
from repro_torch import tree
from repro_torch.configs import get, smoke_config
from repro_torch.convert import params_from_reference, train_state_from_reference
from repro_torch.models import build_model
from repro_torch.train import (
    CodedStateGuard,
    DataConfig,
    OptConfig,
    Prefetcher,
    SyntheticLM,
    apply_updates,
    global_norm,
    init_state,
    latest_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
    schedule,
    state_specs,
)
from repro_torch.train.data import to_device

ATOL_LOSS_F32 = 1e-5
ATOL_LOSS_BF16 = 5e-4
GRAD_SCALE = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
RTOL_F32 = 1e-5
BF16_ULP = 2.0 ** -7
STEP_SLACK = 1.05
STEP_FRACTION = 0.02
STEP_TIGHT_F32 = 1e-6


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def bits(x) -> bytes:
    """The raw bytes of a leaf of either package."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
    return np.asarray(x).tobytes()


def pair(arch="qwen3-1.7b", dtype="float32", n_layers=2, seed=0):
    """(reference model, its params, port model, the same params carried across)."""
    rm = r_build_model(r_smoke_config(arch).replace(dtype=dtype, n_layers=n_layers))
    rp = rm.init(jax.random.key(seed))
    m = build_model(smoke_config(arch).replace(dtype=dtype, n_layers=n_layers))
    return rm, rp, m, params_from_reference(jax.tree.map(np.asarray, rp), m, device="cpu")


def both_batches(b: dict):
    return {k: jnp.asarray(v) for k, v in b.items()}, to_device(b, "cpu")


def grads_of(m, params, batch):
    leaves, treedef = tree.flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss, metrics = m.loss(tree.unflatten(treedef, live), batch)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, torch.autograd.grad(loss, live)


def assert_step_close(port, ref, lr: float):
    """Parameters after a step from zero moments (see the module docstring)."""
    a, r = as_np(port), as_np(ref)
    assert a.shape == r.shape
    bf16 = isinstance(port, torch.Tensor) and port.dtype == torch.bfloat16
    ulp = BF16_ULP * np.abs(r) if bf16 else np.full(r.shape, STEP_TIGHT_F32, np.float32)
    d = np.abs(a - r)
    assert (d <= 2 * lr * STEP_SLACK + ulp).all(), float(d.max())
    assert (d > ulp).mean() <= STEP_FRACTION, float((d > ulp).mean())


# ---------------------------------------------------------------------------
# Model.loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_equal_the_reference(dtype):
    rm, rp, m, p = pair(dtype=dtype)
    b = SyntheticLM(m.cfg).batch(3, 4, 32)
    b["labels"][:, ::5] = -1  # masked positions
    rb, tb = both_batches(b)
    (rl, rmet), rg = jax.jit(jax.value_and_grad(lambda pp: rm.loss(pp, rb), has_aux=True))(rp)
    loss, metrics, grads = grads_of(m, p, tb)
    atol = ATOL_LOSS_F32 if dtype == "float32" else ATOL_LOSS_BF16
    assert sorted(metrics) == sorted(rmet) == ["aux", "ce", "loss"]
    for k in ("ce", "loss"):
        assert abs(float(metrics[k]) - float(rmet[k])) <= atol, k
    assert float(metrics["aux"]) == float(rmet["aux"]) == 0.0
    assert float(loss) == float(metrics["loss"])
    names = list(tree.flatten_with_names(p))
    rleaves = jax.tree.leaves(rg)
    assert len(names) == len(rleaves) == len(grads)
    for name, g, r in zip(names, grads, rleaves):
        assert g.dtype == m.param_specs()["embed"].dtype and tuple(g.shape) == r.shape, name
        r = as_np(r)
        np.testing.assert_allclose(as_np(g), r, rtol=0, atol=GRAD_SCALE[dtype] * float(np.abs(r).max()),
                                   err_msg=name)


def test_loss_of_a_known_case():
    """Uniform logits give ln(vocab); every label masked gives 0 (the mean
    over no position)."""
    m = build_model(smoke_config("qwen3-1.7b").replace(dtype="float32", n_layers=1))
    p = tree.map(torch.zeros_like, m.init(torch.Generator().manual_seed(0)))
    toks = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    loss, metrics = m.loss(p, {"tokens": toks, "labels": toks})
    assert abs(float(loss) - float(np.log(m.cfg.vocab_size))) < 1e-5  # the padded columns carry no mass
    loss, _ = m.loss(p, {"tokens": toks, "labels": torch.full_like(toks, -1)})
    assert float(loss) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_remat_is_the_same_computation(dtype):
    """``remat="block"`` recomputes each block in the backward pass: the loss
    and every gradient equal the run that keeps the activations, bit for bit."""
    _, _, m, p = pair(dtype=dtype)
    mr = build_model(m.cfg.replace(remat="block"))
    b = to_device(SyntheticLM(m.cfg).batch(1, 2, 24), "cpu")
    la, _, ga = grads_of(m, p, b)
    lb, _, gb = grads_of(mr, p, b)
    assert bits(la) == bits(lb)
    assert all(bits(x) == bits(y) for x, y in zip(ga, gb))
    with torch.no_grad():  # no autograd: the blocks run plainly
        assert bits(mr.loss(p, b)[0]) == bits(la)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

SCHED = dict(lr=3e-4, warmup_steps=10, total_steps=60, min_lr_frac=0.1)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 37, 60, 1000])
def test_schedule_equals_the_reference(step):
    got = schedule(OptConfig(**SCHED), torch.tensor(step, dtype=torch.int32))
    want = r_opt.schedule(ROptConfig(**SCHED), jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL_F32, atol=0)
    if step == 0:
        assert float(got) == 0.0
    if step >= SCHED["total_steps"]:
        np.testing.assert_allclose(float(got), SCHED["lr"] * SCHED["min_lr_frac"], rtol=RTOL_F32)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_init_state_and_state_specs_equal_the_reference(moment_dtype):
    _, rp, m, p = pair(dtype="bfloat16")
    got = init_state(OptConfig(moment_dtype=moment_dtype), p)
    want = r_init_state(ROptConfig(moment_dtype=moment_dtype), rp)
    specs = state_specs(OptConfig(moment_dtype=moment_dtype), m.param_specs())
    rspecs = r_opt.state_specs(ROptConfig(moment_dtype=moment_dtype), rp)
    assert str(tree.structure(got)) == str(tree.structure(specs)) == str(jax.tree.structure(want))
    assert str(jax.tree.structure(rspecs)) == str(jax.tree.structure(want))
    for a, s, r in zip(tree.leaves(got), tree.leaves(specs), jax.tree.leaves(want)):
        assert tuple(a.shape) == tuple(s.shape) == r.shape
        assert a.dtype == s.dtype and str(a.dtype).split(".")[-1] == str(r.dtype)
        assert s.device.type == "meta" and a.device.type == "cpu"
        assert not a.any()
    assert got["step"].dtype == torch.int32 and got["step"].shape == ()


def random_tree(like, seed: int, scale: float = 1.0):
    """Numpy-seeded float32 leaves of ``like``'s shapes (one array a leaf)."""
    rng = np.random.default_rng(seed)
    return tree.map(lambda t: (rng.normal(size=tuple(t.shape)) * scale).astype(np.float32), like)


def cast(arrays, like, dtype_of):
    """The same numbers as tensors and as jax arrays, each leaf in ``dtype_of(like leaf)``."""
    tt = tree.map(lambda a, t: torch.from_numpy(a).to(dtype_of(t)), arrays, like)
    jt = tree.map(lambda a, t: jnp.asarray(a, dtype=jnp.bfloat16 if dtype_of(t) == torch.bfloat16
                                            else jnp.float32), arrays, like)
    return tt, jt


def test_global_norm_equals_the_reference():
    _, _, m, p = pair(dtype="bfloat16")
    g_t, g_j = cast(random_tree(p, 7), p, lambda t: t.dtype)
    got, want = global_norm(g_t), r_opt.global_norm(g_j)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL_F32)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1e-3, 1.0])  # below and above the clip norm
def test_apply_updates_equals_the_reference(moment_dtype, grad_scale):
    """One AdamW step at step 3 from nonzero moments, bf16 parameters: the
    new parameters, moments, step and metrics."""
    _, rp, m, p = pair(dtype="bfloat16")
    mdt = torch.float32 if moment_dtype == "float32" else torch.bfloat16
    g_t, g_j = cast(random_tree(p, 11, grad_scale), p, lambda t: t.dtype)
    m_t, m_j = cast(random_tree(p, 12, 0.01), p, lambda t: mdt)
    v_t, v_j = cast(tree.map(np.abs, random_tree(p, 13, 1e-4)), p, lambda t: mdt)
    cfg, rcfg = OptConfig(moment_dtype=moment_dtype, lr=1e-3), ROptConfig(moment_dtype=moment_dtype, lr=1e-3)
    st = {"m": m_t, "v": v_t, "step": torch.tensor(3, dtype=torch.int32)}
    got_p, got_s, got_m = apply_updates(cfg, p, g_t, st)
    want_p, want_s, want_m = r_opt.apply_updates(rcfg, rp, g_j, {"m": m_j, "v": v_j, "step": jnp.int32(3)})
    assert int(got_s["step"]) == 4 and got_s["step"].dtype == torch.int32 and int(st["step"]) == 3
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), rtol=RTOL_F32)
    for got, want in ((got_p, want_p), (got_s["m"], want_s["m"]), (got_s["v"], want_s["v"])):
        assert str(tree.structure(got)) == str(jax.tree.structure(want))
        for a, r in zip(tree.leaves(got), jax.tree.leaves(want)):
            assert str(a.dtype).split(".")[-1] == str(r.dtype)
            r = as_np(r)
            tol = RTOL_F32 * np.abs(r).max() + (BF16_ULP * np.abs(r) if a.dtype == torch.bfloat16 else 0.0)
            assert (np.abs(as_np(a) - r) <= tol).all()


def test_weight_decay_reaches_stacked_norms():
    """With zero gradients only the decay moves a parameter: every leaf with
    ``ndim >= 2`` — the stacked norm scales ``(n_layers, d)`` too — shrinks by
    lr · wd · p, and the 1-D final norm stays; as in the reference."""
    _, rp, m, p = pair(dtype="float32")
    cfg, rcfg = OptConfig(lr=1e-2, warmup_steps=1), ROptConfig(lr=1e-2, warmup_steps=1)
    zeros = tree.map(torch.zeros_like, p)
    new_p, _, metrics = apply_updates(cfg, p, zeros, init_state(cfg, p))
    want_p, _, _ = r_opt.apply_updates(rcfg, rp, jax.tree.map(jnp.zeros_like, rp), r_init_state(rcfg, rp))
    lr = float(metrics["lr"])
    assert tuple(p["body"]["b0"]["ln1"]["scale"].shape) == (2, 64)
    for name, a, old, r in zip(tree.flatten_with_names(p), tree.leaves(new_p), tree.leaves(p),
                               jax.tree.leaves(want_p)):
        expect = old * (1 - lr * cfg.weight_decay) if old.ndim >= 2 else old
        np.testing.assert_allclose(as_np(a), as_np(expect), rtol=RTOL_F32, atol=0, err_msg=name)
        np.testing.assert_allclose(as_np(a), as_np(r), rtol=RTOL_F32, atol=0, err_msg=name)
    assert torch.equal(new_p["ln_f"]["scale"], p["ln_f"]["scale"])
    assert not torch.equal(new_p["body"]["b0"]["ln1"]["scale"], p["body"]["b0"]["ln1"]["scale"])


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,smoke", [("qwen3-1.7b", True), ("qwen3-1.7b", False), ("deepseek-coder-33b", True)])
@pytest.mark.parametrize("step,shard,n_shards", [(0, 0, 1), (7, 0, 1), (3, 1, 4)])
def test_synthetic_batches_equal_the_reference(arch, smoke, step, shard, n_shards):
    cfg = smoke_config(arch) if smoke else get(arch)
    rcfg = r_smoke_config(arch) if smoke else cfg  # the configs are equal (test_torch_models)
    dcfg = DataConfig(seed=99)
    got = SyntheticLM(cfg, dcfg).batch(step, 3, 40, shard, n_shards)
    want = RSyntheticLM(rcfg, RDataConfig(seed=99)).batch(step, 3, 40, shard, n_shards)
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["tokens"] >= 0).all() and (got["tokens"] < cfg.vocab_size).all()


def test_prefetcher_yields_each_step_in_order_on_its_device():
    ds = SyntheticLM(smoke_config("qwen3-1.7b"))
    pf = Prefetcher(ds, 2, 16, start_step=5, depth=2, device="cpu")
    try:
        for s in (5, 6, 7):
            step, b = pf.next()
            assert step == s
            want = ds.batch(s, 2, 16)
            for k in want:
                assert b[k].device.type == "cpu" and b[k].dtype == torch.int32
                np.testing.assert_array_equal(b[k].numpy(), want[k])
    finally:
        pf.close()
    assert not pf.t.is_alive()


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_equals_the_reference(accum):
    rm, rp, m, p = pair("deepseek-coder-33b", dtype="bfloat16", n_layers=1, seed=1)
    cfg, rcfg = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10), ROptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    b = r_make_batch(r_smoke_config("deepseek-coder-33b"), 4, 16, seed=5)
    rb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = to_device({k: np.array(v) for k, v in b.items()}, "cpu")
    want = jax.jit(r_make_train_step(rm, rcfg, accum=accum))(rp, r_init_state(rcfg, rp), rb)
    st = init_state(cfg, p)
    got = make_train_step(m, cfg, accum=accum)(p, st, tb)
    assert sorted(got[2]) == sorted(want[2]) == ["aux", "ce", "grad_norm", "loss", "lr"]
    for k in ("loss", "ce"):
        assert abs(float(got[2][k]) - float(want[2][k])) <= ATOL_LOSS_BF16, k
    np.testing.assert_allclose(float(got[2]["grad_norm"]), float(want[2]["grad_norm"]), rtol=GRAD_SCALE["bfloat16"])
    assert float(got[2]["lr"]) == float(want[2]["lr"])
    lr = float(got[2]["lr"])
    for name, a, r in zip(tree.flatten_with_names(p), tree.leaves(got[0]), jax.tree.leaves(want[0])):
        assert a.dtype == torch.bfloat16, name
        assert_step_close(a, r, lr)
    assert int(got[1]["step"]) == int(want[1]["step"]) == 1
    assert int(st["step"]) == 0 and not st["m"]["embed"].any()  # the inputs are left as they were


def test_grad_accum_matches_full_batch():
    """The reference test's case, within the port: the same data through one
    batch and two micro-batches gives the same update at its tolerance (2e-2:
    float sums in another order, bf16)."""
    _, _, m, p = pair("deepseek-coder-33b", dtype="bfloat16", n_layers=1, seed=1)
    cfg = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    b = to_device({k: np.array(v) for k, v in r_make_batch(r_smoke_config("deepseek-coder-33b"), 4, 16,
                                                               seed=5).items()}, "cpu")
    o1 = make_train_step(m, cfg, accum=1)(p, init_state(cfg, p), b)
    o2 = make_train_step(m, cfg, accum=2)(p, init_state(cfg, p), b)
    for a, c in zip(tree.leaves(o1[0]), tree.leaves(o2[0])):
        np.testing.assert_allclose(as_np(a), as_np(c), rtol=2e-2, atol=2e-2)


def test_train_loss_decreases():
    m = build_model(smoke_config("qwen3-1.7b").replace(n_layers=2))
    p = m.init(torch.Generator().manual_seed(0))
    cfg = OptConfig(lr=3e-3, warmup_steps=5, total_steps=60, weight_decay=0.0)
    st = init_state(cfg, p)
    step = make_train_step(m, cfg)
    ds = SyntheticLM(m.cfg)
    losses = []
    for s in range(30):
        p, st, metrics = step(p, st, to_device(ds.batch(s % 4, 4, 32), "cpu"))
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.5, losses[:3] + losses[-3:]


def test_train_step_frees_the_replaced_state_without_the_cyclic_collector():
    """The state a step replaces, and its gradients, are freed by reference
    counting alone: nothing of a step lives on in a reference cycle, whose
    release would wait for Python's cyclic collector (and so, on the card,
    move the train step's peak bytes with the whole process's history)."""
    m, p, st, step, ds = _setup()
    gc.collect()
    gc.disable()
    try:
        p1, s1, _ = step(p, st, to_device(ds.batch(0, 2, 16), "cpu"))
        refs = [weakref.ref(x) for x in tree.leaves((p1, s1["m"], s1["v"]))]
        p2, s2, _ = step(p1, s1, to_device(ds.batch(1, 2, 16), "cpu"))
        del p1, s1
        assert refs and all(r() is None for r in refs)
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# resumes (tests/test_system.py's cases, within the port) and checkpoints
# ---------------------------------------------------------------------------


def _setup():
    m = build_model(smoke_config("qwen3-1.7b").replace(n_layers=1))
    p = m.init(torch.Generator().manual_seed(0))
    cfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    return m, p, init_state(cfg, p), make_train_step(m, cfg), SyntheticLM(m.cfg)


def _run(step_fn, ds, params, ostate, steps, start=0):
    for s in range(start, start + steps):
        params, ostate, _ = step_fn(params, ostate, to_device(ds.batch(s, 2, 16), "cpu"))
    return params, ostate


def assert_same_state(a, b):
    assert tree.structure(a) == tree.structure(b)
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape and bits(x) == bits(y)


def test_coded_recovery_resumes_identically():
    m, params, ostate, step_fn, ds = _setup()
    p_ref, o_ref = _run(step_fn, ds, params, ostate, 6)
    p, o = _run(step_fn, ds, params, ostate, 3)
    guard = CodedStateGuard(K=8, device="cpu")
    guard.snapshot({"params": p, "opt": o}, step=3)
    recovered, at_step = guard.fail_and_recover(lost=[1, 4, 6])
    assert at_step == 3
    assert_same_state(recovered, {"params": p, "opt": o})
    p2, o2 = _run(step_fn, ds, recovered["params"], recovered["opt"], 3, start=3)
    assert_same_state({"params": p2, "opt": o2}, {"params": p_ref, "opt": o_ref})


def test_disk_restart_resumes_identically(tmp_path):
    m, params, ostate, step_fn, ds = _setup()
    p_ref, o_ref = _run(step_fn, ds, params, ostate, 6)
    p, o = _run(step_fn, ds, params, ostate, 3)
    save_checkpoint(str(tmp_path / "c"), {"params": p, "opt": o}, step=3)
    like = {"params": m.param_specs(), "opt": state_specs(OptConfig(), m.param_specs())}
    restored, step = restore_checkpoint(str(tmp_path / "c"), like, device="cpu")
    assert step == 3 == latest_step(str(tmp_path / "c"))
    p2, o2 = _run(step_fn, ds, restored["params"], restored["opt"], 3, start=3)
    assert_same_state({"params": p2, "opt": o2}, {"params": p_ref, "opt": o_ref})


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_train_state_crosses_the_packages_byte_for_byte(tmp_path, moment_dtype):
    """A train state the reference trained and saved: the port restores it,
    equal to ``train_state_from_reference`` bit for bit, and saves it back
    with every array's bytes, shape and dtype equal to the reference's file."""
    rm, rp, m, _ = pair(dtype="bfloat16", n_layers=1)
    rcfg, cfg = ROptConfig(moment_dtype=moment_dtype), OptConfig(moment_dtype=moment_dtype)
    b = {k: jnp.asarray(v) for k, v in RSyntheticLM(rm.cfg).batch(0, 2, 16).items()}
    rp, ro, _ = jax.jit(r_make_train_step(rm, rcfg))(rp, r_init_state(rcfg, rp), b)
    r_save_checkpoint(str(tmp_path / "ref"), {"params": rp, "opt": ro}, step=1)
    like = {"params": m.param_specs(), "opt": state_specs(cfg, m.param_specs())}
    restored, step = restore_checkpoint(str(tmp_path / "ref"), like, device="cpu")
    carried = train_state_from_reference(jax.tree.map(np.asarray, {"params": rp, "opt": ro}), m, cfg, device="cpu")
    assert step == 1
    assert_same_state(restored, carried)
    save_checkpoint(str(tmp_path / "port"), restored, step=1)
    with np.load(str(tmp_path / "ref" / "state_00000001.npz")) as want, \
            np.load(str(tmp_path / "port" / "state_00000001.npz")) as got:
        assert sorted(got.files) == sorted(want.files) and len(got.files) == len(tree.leaves(restored))
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k
    assert os.path.isfile(str(tmp_path / "port" / "manifest.json"))


def test_train_state_from_reference_checks_the_optimizer_state():
    _, rp, m, _ = pair(dtype="bfloat16", n_layers=1)
    rp = jax.tree.map(np.asarray, rp)
    ro = jax.tree.map(np.asarray, r_init_state(ROptConfig(moment_dtype="bfloat16"), rp))
    got = train_state_from_reference({"params": rp, "opt": ro}, m, OptConfig(moment_dtype="bfloat16"), device="cpu")
    assert got["opt"]["m"]["embed"].dtype == torch.bfloat16 and got["opt"]["step"].dtype == torch.int32
    with pytest.raises(ValueError, match="bfloat16"):  # the moments are not float32
        train_state_from_reference({"params": rp, "opt": ro}, m, OptConfig(), device="cpu")
    with pytest.raises(ValueError, match="optimizer state"):
        train_state_from_reference({"params": rp, "opt": {"m": ro["m"], "v": ro["v"]}}, m,
                                   OptConfig(moment_dtype="bfloat16"), device="cpu")
    with pytest.raises(ValueError, match="params"):
        train_state_from_reference({"params": rp}, m, OptConfig(), device="cpu")
