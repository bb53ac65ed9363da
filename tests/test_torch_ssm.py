"""Differential tests of the port's SSM families (``repro_torch.models.ssm``,
the ``"mamba"``, ``"mamba_moe"`` and ``"rwkv"`` layer kinds, Jamba and
RWKV6) against the JAX package on the CPU.

The same numpy-seeded inputs go through ``repro.models`` and
``repro_torch.models`` (``device="cpu"``); parameters are carried across by
``repro_torch.convert.params_from_reference``, bfloat16 by its bits, which
also holds the pytree's leaf order to the reference's. Jamba's smoke config
is one period of four layers (Mamba, Mamba-MoE, Mamba, attention-MoE);
RWKV6's two RWKV layers. Tolerances, those of ``tests/test_torch_models.py``
and ``tests/test_torch_mla.py``:

* integer and bit-level results (greedy tokens, coded shards over GF(q),
  the leaves ``init`` makes without a draw, a cache after a guard's
  recovery, chunked against unchunked scans, shapes and dims): equal;
* float32 modules ``ATOL_F32`` (1e-5) absolute; bfloat16 modules within
  ``BF16_SCALE`` (2^-6) of the largest reference value — XLA and PyTorch
  round bf16 products at other points;
* float32 model logits ``ATOL_LOGITS_F32`` (1e-4), bfloat16 logits
  ``ATOL_LOGITS_BF16`` (3e-2); the loss ``ATOL_LOSS_F32`` (1e-5);
  gradients within ``GRAD_SCALE`` (1e-5) of each leaf's largest reference
  gradient;
* decode against the teacher-forced forward, within the port: the
  reference's own tolerances (RWKV6 0.15, Jamba 0.2).

Jamba's MoE layers route by the router's float32 logits; in bf16 the two
packages round the activations before the router at other points, and a
near-tie can route a token otherwise (ROADMAP.md, "bf16 router near-ties"),
so Jamba's whole-model comparisons with the reference are made at float32.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as R_ARCHS
from repro.configs import smoke_config as r_smoke_config
from repro.models import build_model as r_build_model
from repro.models import make_batch as r_make_batch
from repro.models import ssm as RSSM
from repro.obs.metrics import MetricsRegistry as RMetricsRegistry
from repro.serve import CodedServeGuard as RCodedServeGuard
from repro.serve import Engine as REngine
from repro.train import OptConfig as ROptConfig
from repro.train import init_state as r_init_state
from repro.train import make_train_step as r_make_train_step
from repro.train import restore_checkpoint as r_restore_checkpoint
from repro_torch import tree
from repro_torch.configs import get, smoke_config
from repro_torch.convert import params_from_reference, state_from_reference
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import build_model, make_batch, ssm as SSM
from repro_torch.obs import MetricsRegistry
from repro_torch.serve import CodedServeGuard, ContinuousEngine, Engine, FaultInjector
from repro_torch.train import OptConfig, init_state, make_decode_step, make_train_step, save_checkpoint
from repro_torch.train import restore_checkpoint
from repro_torch.train.data import to_device

ATOL_F32 = 1e-5
BF16_SCALE = 2.0 ** -6
ATOL_LOGITS_F32 = 1e-4
ATOL_LOGITS_BF16 = 3e-2
ATOL_LOSS_F32 = 1e-5
GRAD_SCALE = 1e-5

JAMBA, RWKV = "jamba-v0.1-52b", "rwkv6-3b"
ARCHS = [JAMBA, RWKV]
V = 503  # the smoke vocabulary (padded to 512)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: the leaves of a layer that ``init`` makes without a draw
UNDRAWN = ("mamba/A_log", "mamba/D", "mamba/conv_b", "mamba/dt_proj_b", "tm/w0", "tm/ln_x/scale", "tm/ln_x/bias")


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


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
def pair(arch: str, dtype: str = "float32", seed: int = 0):
    """(reference model, reference params, port model, port params) of the
    smoke config, the parameters carried across."""
    rm = r_build_model(r_smoke_config(arch).replace(dtype=dtype))
    rp = rm.init(jax.random.key(seed))
    m = build_model(smoke_config(arch).replace(dtype=dtype))
    return rm, rp, m, params_from_reference(jax.tree.map(np.asarray, rp), m, device="cpu")


def normal(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def module_pair(kind: str, dtype: str):
    """(reference cfg, reference params, port cfg, port params) of one
    mixer (``mamba``, ``rwkv`` time mix or ``cm`` channel mix) of the smoke
    configs, drawn by the reference and carried across."""
    arch = JAMBA if kind == "mamba" else RWKV
    rcfg, cfg = r_smoke_config(arch).replace(dtype=dtype), smoke_config(arch).replace(dtype=dtype)
    init = {"mamba": RSSM.mamba_init, "rwkv": RSSM.rwkv6_init, "cm": RSSM.rwkv6_channel_mix_init}[kind]
    rp = init(jax.random.key(3), rcfg, DTYPES[dtype][0])
    return rcfg, rp, cfg, state_from_reference(jax.tree.map(np.asarray, rp), device="cpu")


@pytest.mark.parametrize("kind", ["mamba", "rwkv", "cm"])
def test_module_init_and_specs_equal_the_reference(kind):
    """Each mixer's pytree, shapes and dtypes (meta tensors from ``None``)
    and logical dims equal the reference's; the leaves made without a draw
    hold the reference's bits."""
    rcfg, rp, cfg, _ = module_pair(kind, "bfloat16")
    init = {"mamba": SSM.mamba_init, "rwkv": SSM.rwkv6_init, "cm": SSM.rwkv6_channel_mix_init}[kind]
    got = init(None, cfg)
    assert tree.structure(got) == tree.structure(rp)
    for a, b in zip(tree.leaves(got), jax.tree.leaves(rp)):
        assert a.device.type == "meta" and tuple(a.shape) == b.shape and str(b.dtype) in str(a.dtype)
    specs = {"mamba": (SSM.mamba_specs(cfg), RSSM.mamba_specs(rcfg)),
             "rwkv": (SSM.rwkv6_specs(cfg), RSSM.rwkv6_specs(rcfg)),
             "cm": (SSM.rwkv6_channel_mix_specs(), RSSM.rwkv6_channel_mix_specs())}[kind]
    assert specs[0] == specs[1]
    made = init(torch.Generator().manual_seed(0), cfg)
    ref = dict(zip(tree.flatten_with_names(rp), jax.tree.leaves(rp)))
    undrawn = [k for k in tree.flatten_with_names(made) if k in ("A_log", "D", "conv_b", "dt_proj_b", "w0")
               or k.startswith(("ln_x", "dt_norm", "b_norm", "c_norm"))]
    assert len(undrawn) == {"mamba": 7, "rwkv": 3, "cm": 0}[kind]
    for k in undrawn:
        a = tree.flatten_with_names(made)[k]
        assert str(ref[k].dtype) in str(a.dtype) and bits(a) == bits(ref[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 9])
def test_mamba_fwd_and_its_state_equal_the_reference(dtype, S):
    """The whole sequence from zeros, and the steps after a given state
    (``h0``, ``conv0``): the output, ``h`` and the conv tail."""
    rcfg, rp, cfg, p = module_pair("mamba", dtype)
    jd, td = DTYPES[dtype]
    x = normal(S, (2, S, cfg.d_model))
    h0 = normal(S + 1, (2, 2 * cfg.d_model, cfg.ssm.d_state), 0.5)
    c0 = normal(S + 2, (2, cfg.ssm.d_conv - 1, 2 * cfg.d_model))
    for state in (None, (h0, c0)):
        kw = {} if state is None else {"h0": torch.from_numpy(state[0]), "conv0": torch.from_numpy(state[1]).to(td)}
        rkw = {} if state is None else {"h0": jnp.asarray(state[0]), "conv0": jnp.asarray(state[1], jd)}
        y, (h, tail) = SSM.mamba_fwd(p, torch.from_numpy(x).to(td), cfg, return_state=True, **kw)
        ry, (rh, rtail) = RSSM.mamba_fwd(rp, jnp.asarray(x, jd), rcfg, return_state=True, **rkw)
        assert y.dtype == td and h.dtype == torch.float32 and tail.shape == (2, cfg.ssm.d_conv - 1, 2 * cfg.d_model)
        assert_close(y, ry, dtype)
        assert_close(h, rh, "float32" if dtype == "float32" else dtype)
        assert_close(tail, rtail, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_writes_the_state_in_place(dtype):
    """Six decode steps: the output equals the reference's, and the state's
    own tensors (views, as the stacked cache hands them) hold the new state."""
    rcfg, rp, cfg, p = module_pair("mamba", dtype)
    jd, td = DTYPES[dtype]
    stacked = SSM.mamba_state_init(cfg, 2, td, "cpu", layers=3)
    state = tuple(a[1] for a in stacked)
    rstate = RSSM.mamba_state_init(rcfg, 2, jd)
    for t in range(6):
        x = normal(20 + t, (2, 1, cfg.d_model))
        y, out = SSM.mamba_decode(p, torch.from_numpy(x).to(td), cfg, state)
        ry, rstate = RSSM.mamba_decode(rp, jnp.asarray(x, jd), rcfg, rstate)
        assert out is state
        assert_close(y, ry, dtype)
    for got, want in zip(stacked, rstate):
        assert_close(got[1], want, dtype)
        assert not got[0].any() and not got[2].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 7])
def test_rwkv6_time_and_channel_mix_equal_the_reference(dtype, S):
    """Both RWKV6 mixers from zeros and after a given state (``wkv`` and the
    token-shift rows): outputs and returned states."""
    rcfg, rp, cfg, p = module_pair("rwkv", dtype)
    _, rpc, _, pc = module_pair("cm", dtype)
    jd, td = DTYPES[dtype]
    H, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    x = normal(S, (2, S, cfg.d_model))
    s0, x0 = normal(S + 1, (2, H, hd, hd), 0.3), normal(S + 2, (2, 1, cfg.d_model))
    for given in (False, True):
        kw = dict(state=torch.from_numpy(s0), x_prev=torch.from_numpy(x0).to(td)) if given else {}
        rkw = dict(state=jnp.asarray(s0), x_prev=jnp.asarray(x0, jd)) if given else {}
        y, (wkv, last) = SSM.rwkv6_time_mix(p, torch.from_numpy(x).to(td), cfg, return_state=True, **kw)
        ry, (rwkv, rlast) = RSSM.rwkv6_time_mix(rp, jnp.asarray(x, jd), rcfg, return_state=True, **rkw)
        assert y.dtype == td and wkv.dtype == torch.float32
        assert_close(y, ry, dtype)
        assert_close(wkv, rwkv, dtype)
        assert bits(last) == bits(rlast)
        xp = dict(x_prev=kw["x_prev"]) if given else {}
        rxp = dict(x_prev=rkw["x_prev"]) if given else {}
        c, clast = SSM.rwkv6_channel_mix(pc, torch.from_numpy(x).to(td), return_state=True, **xp)
        rc, rclast = RSSM.rwkv6_channel_mix(rpc, jnp.asarray(x, jd), return_state=True, **rxp)
        assert_close(c, rc, dtype)
        assert bits(clast) == bits(rclast)


def _scan_inputs(scan: str, S: int = 12):
    """Float32 inputs of ``_mamba_scan`` or ``_wkv6_scan`` (the scanned
    ones first), from numpy."""
    if scan == "mamba":
        B, Din, N = 2, 6, 4
        u, B_, C = normal(1, (B, S, Din)), normal(2, (B, S, N)), normal(3, (B, S, N))
        dt = np.log1p(np.exp(normal(4, (B, S, Din))))
        A = -np.exp(normal(5, (Din, N), 0.5))
        return (u, dt, B_, C), (A, np.ones(Din, np.float32) * 0.5), normal(6, (B, Din, N))
    B, H, hd = 2, 3, 4
    r, k, v = normal(1, (B, S, H, hd)), normal(2, (B, S, H, hd)), normal(3, (B, S, H, hd))
    w = np.exp(-np.exp(normal(4, (B, S, H, hd), 0.5)))
    return (r, k, v, w), (normal(5, (H, hd), 0.3),), normal(6, (B, H, hd, hd))


def _port_scan(scan: str, xs, consts, s0, time_chunk: int):
    if scan == "mamba":
        u, dt, B, C = xs
        return SSM._mamba_scan(u, dt, B, C, *consts, h0=s0, time_chunk=time_chunk)
    return SSM._wkv6_scan(*xs, *consts, S0=s0, time_chunk=time_chunk)


@pytest.mark.parametrize("scan", ["mamba", "wkv6"])
def test_scans_chunked_equal_unchunked_with_gradients(scan):
    """``time_chunk`` 4 over 12 steps (three checkpointed chunks) against 0:
    the same outputs, last state and gradients of every input, bit for bit;
    both equal the reference's scan (chunked and not) within ``ATOL_F32``."""
    xs_np, consts_np, s0_np = _scan_inputs(scan)
    runs = []
    for chunk in (0, 4):
        xs = [torch.from_numpy(a).requires_grad_(True) for a in xs_np]
        consts = [torch.from_numpy(a).requires_grad_(True) for a in consts_np]
        s0 = torch.from_numpy(s0_np).requires_grad_(True)
        y, last = _port_scan(scan, xs, consts, s0, chunk)
        loss = (y * torch.linspace(-1, 1, y.shape[-1])).sum() + (last ** 2).sum()
        runs.append((y.detach(), last.detach(), torch.autograd.grad(loss, [*xs, *consts, s0])))
    (y0, l0, g0), (y4, l4, g4) = runs
    assert torch.equal(y0, y4) and torch.equal(l0, l4)
    assert all(torch.equal(a, b) for a, b in zip(g0, g4))
    with torch.no_grad():  # no autograd: the chunked form runs unchunked
        assert torch.equal(_port_scan(scan, [torch.from_numpy(a) for a in xs_np],
                                      [torch.from_numpy(a) for a in consts_np], torch.from_numpy(s0_np), 4)[0], y0)
    for chunk in (0, 4):
        if scan == "mamba":
            ry, rlast = RSSM._mamba_scan(*map(jnp.asarray, xs_np), *map(jnp.asarray, consts_np),
                                         h0=jnp.asarray(s0_np), time_chunk=chunk)
        else:
            ry, rlast = RSSM._wkv6_scan(*map(jnp.asarray, xs_np), *map(jnp.asarray, consts_np),
                                        S0=jnp.asarray(s0_np), time_chunk=chunk)
        assert_close(y0, ry, "float32")
        assert_close(l0, rlast, "float32")


def test_time_chunk_model_loss_and_gradients_equal_unchunked():
    """RWKV6's smoke model with ``time_chunk=4`` (the ``OPT`` profile's
    lever) over 12 tokens: the loss and every gradient equal the unchunked
    model's, bit for bit."""
    _, _, m, p = pair(RWKV)
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, V, size=(2, 12)).astype(np.int32))
    out = []
    for model in (m, build_model(m.cfg.replace(time_chunk=4))):
        leaves, treedef = tree.flatten(p)
        live = [t.detach().requires_grad_(True) for t in leaves]
        loss, _ = model.loss(tree.unflatten(treedef, live), {"tokens": toks, "labels": toks})
        out.append((loss.detach(), torch.autograd.grad(loss, live)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# ---------------------------------------------------------------------------
# the models: pattern, params, caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_params_dims_and_cache_carry_across_in_the_reference_leaf_order(arch):
    """The pattern, the parameters' pytree (shapes, dtypes, leaf order), the
    logical dims of parameters and cache (a Mamba state's dims are a tuple
    of two tuples), and ``init_cache``'s leaves equal the reference's."""
    rm, rp, m, p = pair(arch, "bfloat16")
    assert (m.prefix, m.body, m.repeats) == (rm.prefix, rm.body, rm.repeats)
    assert tree.structure(p) == tree.structure(m.param_specs()) == tree.structure(rp)
    for got, want in zip(tree.leaves(p), jax.tree.leaves(rp)):
        assert tuple(got.shape) == want.shape and str(want.dtype) in str(got.dtype)
    assert m.param_dims() == rm.param_specs()[1]
    assert m.cache_dims() == rm.cache_dims()
    rc, c = rm.init_cache(3, 10), m.init_cache(3, 10, device="cpu")
    assert tree.structure(c) == tree.structure(rc)
    assert list(tree.flatten_with_names(c)) == ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
                                                for path, _ in jax.tree_util.tree_flatten_with_path(rc)[0]]
    for got, want in zip(tree.leaves(c), jax.tree.leaves(rc)):
        assert tuple(got.shape) == want.shape and str(want.dtype) in str(got.dtype) and not got.any()
    assert not m.supports_prefill and not rm.supports_prefill


@pytest.mark.parametrize("arch", ARCHS)
def test_init_undrawn_leaves_equal_the_reference_in_every_layer(arch):
    """``Model.init`` fills each stacked leaf layer by layer: in every layer
    the leaves made without a draw hold the reference's bits."""
    rm, rp, m, _ = pair(arch, "bfloat16")
    made = tree.flatten_with_names(m.init(torch.Generator().manual_seed(1)))
    ref = dict(zip(tree.flatten_with_names(m.param_specs()), jax.tree.leaves(rp)))
    names = [k for k in made if k.split("/", 2)[-1] in UNDRAWN]
    assert len(names) == {JAMBA: 3 * 4, RWKV: 3}[arch]
    for k in names:
        assert made[k].shape[0] == m.repeats and bits(made[k]) == bits(ref[k]), k


@pytest.mark.parametrize("arch, n_layers, weights, tick, state", [
    (RWKV, 32, 5_780_280_320, 5_444_736_000, 85_196_800),
    (JAMBA, 16, 52_112_375_680, 51_575_504_768, 65_667_072),
    (RWKV, 16, 3_225_687_040, 2_890_142_720, 42_598_400),
    (JAMBA, 8, 26_593_062_848, 26_056_191_936, 32_833_536),
])
def test_full_width_param_specs_dims_and_bytes(arch, n_layers, weights, tick, state):
    """Every leaf's shape and dtype and the logical dims of the whole model
    equal the reference's ``param_specs``; at ``n_layers`` (RWKV6-3B whole
    and at 16 layers, Jamba at 2 of its 4 periods and at one, the depths
    ``chip_smoke.py`` serves at) the model holds these bytes of bf16
    weights, a tick reads all but ``embed``, and the decode state at 4 rows
    × 1,024 positions holds these bytes."""
    m = build_model(get(arch))
    rshapes, rdims = r_build_model(R_ARCHS[arch]).param_specs()
    spec = m.param_specs()
    assert tree.structure(spec) == tree.structure(rshapes)
    for (name, got), want in zip(tree.flatten_with_names(spec).items(), jax.tree.leaves(rshapes)):
        assert got.device.type == "meta" and tuple(got.shape) == want.shape and str(want.dtype) in str(got.dtype), name
    assert m.param_dims() == rdims
    assert m.cache_dims() == r_build_model(R_ARCHS[arch]).cache_dims()
    cut = build_model(get(arch).replace(n_layers=n_layers))
    by = lambda t: sum(x.numel() * x.element_size() for x in tree.leaves(t))  # noqa: E731
    s = cut.param_specs()
    assert (by(s), by(s) - by(s["embed"]), by(cut.init_cache(4, 1024, device="meta"))) == (weights, tick, state)


# ---------------------------------------------------------------------------
# forward, loss, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch, dtype", [(JAMBA, "float32"), (RWKV, "float32"), (RWKV, "bfloat16")])
def test_forward_logits_and_aux(arch, dtype):
    rm, rp, m, p = pair(arch, dtype)
    toks = np.random.default_rng(0).integers(0, V, size=(2, 21)).astype(np.int32)
    logits, aux, _ = m.forward(p, {"tokens": torch.from_numpy(toks)})
    rlogits, raux, _ = jax.jit(rm.forward)(rp, {"tokens": jnp.asarray(toks)})
    assert_logits(logits, rlogits, dtype)
    np.testing.assert_allclose(float(aux), float(raux), rtol=0, atol=ATOL_LOSS_F32)
    assert (float(aux) > 0) == (arch == JAMBA)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients(arch):
    rm, rp, m, p = pair(arch)
    toks = np.random.default_rng(3).integers(0, V, size=(2, 12)).astype(np.int32)
    labels = toks.copy()
    labels[:, ::5] = -1
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (rl, rmet), rg = jax.jit(jax.value_and_grad(lambda pp: rm.loss(pp, rb), has_aux=True))(rp)
    leaves, treedef = tree.flatten(p)
    live = [t.detach().requires_grad_(True) for t in leaves]
    loss, metrics = m.loss(tree.unflatten(treedef, live), {"tokens": torch.from_numpy(toks),
                                                         "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(loss, live)
    for k in ("loss", "ce", "aux"):
        assert abs(float(metrics[k].detach()) - float(rmet[k])) <= ATOL_LOSS_F32, k
    for name, g, r in zip(tree.flatten_with_names(p), grads, jax.tree.leaves(rg)):
        r = as_np(r)
        np.testing.assert_allclose(as_np(g), r, rtol=0, atol=GRAD_SCALE * float(np.abs(r).max()), err_msg=name)


@pytest.mark.parametrize("arch, dtype", [(JAMBA, "float32"), (RWKV, "float32"), (RWKV, "bfloat16")])
def test_decode_step_logits_and_cache(arch, dtype):
    """Eight ``decode_step``s of three rows: the logits, and the stacked
    cache, written in place (the step returns the same tensors), equal the
    reference's."""
    rm, rp, m, p = pair(arch, dtype)
    B, smax = 3, 16
    rcache, cache = rm.init_cache(B, smax), m.init_cache(B, smax, device="cpu")
    held = tree.leaves(cache)
    toks = np.random.default_rng(1).integers(0, V, size=(B, 8)).astype(np.int32)
    step, rstep = make_decode_step(m), jax.jit(rm.decode_step)
    for t in range(8):
        pos = np.full((B,), t, np.int32)
        lg, out = step(p, cache, torch.from_numpy(toks[:, t:t + 1]), torch.from_numpy(pos))
        rlg, rcache = rstep(rp, rcache, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos))
        assert out is cache
        assert_logits(lg, rlg, dtype)
    assert all(a is b for a, b in zip(tree.leaves(cache), held))
    for got, want in zip(tree.leaves(cache), jax.tree.leaves(rcache)):
        assert_close(got, want, dtype)


@pytest.mark.parametrize("arch, tol", [(RWKV, 0.15), (JAMBA, 0.2)])
def test_decode_matches_forward(arch, tol):
    """The reference's ``test_decode_matches_forward_rwkv`` and Jamba's case
    of ``test_decode_matches_forward_more_archs``: bf16 decode token by token
    reproduces the teacher-forced forward at their tolerances; the batch is
    the reference's."""
    rm, _, m, p = pair(arch, "bfloat16")
    B, S = 2, 8
    seed = 4 if arch == RWKV else 6
    batch = make_batch(m.cfg, B, S, seed=seed, device="cpu")
    np.testing.assert_array_equal(batch["tokens"].numpy(), np.asarray(r_make_batch(rm.cfg, B, S, seed=seed)["tokens"]))
    full, _, _ = m.forward(p, batch)
    cache = m.init_cache(B, S, device="cpu")
    for t in range(S):
        lg, cache = m.decode_step(p, cache, batch["tokens"][:, t:t + 1], torch.full((B,), t, dtype=torch.int32))
        np.testing.assert_allclose(as_np(lg[:, 0, :V]), as_np(full[:, t, :V]), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# serving, the guard, a checkpoint, a train step and the launcher
# ---------------------------------------------------------------------------

PROMPTS = [[5, 9, 2, 7, 1], [3, 3, 8], [11, 4, 6, 2, 9, 10, 1]]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_unsupported_kinds_fall_back(arch):
    """``tests/test_serve.py``'s case: no one-pass prefill, so the
    continuous engine and ``prefill_into_cache`` refuse the recurrent
    families."""
    _, _, m, p = pair(arch)
    assert not m.supports_prefill
    with pytest.raises(NotImplementedError):
        ContinuousEngine(m, p, n_slots=2, max_len=32)
    with pytest.raises(NotImplementedError):
        m.prefill_into_cache(p, m.init_cache(1, 8, device="cpu"), torch.zeros((1, 8), dtype=torch.int32), 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_fixed_engine_greedy_tokens_equal_the_reference(arch):
    rm, rp, m, p = pair(arch)
    got = Engine(m, p, max_len=24, metrics=MetricsRegistry()).generate(PROMPTS, max_new_tokens=6)
    want = REngine(rm, rp, max_len=24, metrics=RMetricsRegistry()).generate(PROMPTS, max_new_tokens=6)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths, want.lengths)


@pytest.mark.parametrize("arch, dtype", [(JAMBA, "float32"), (RWKV, "bfloat16")])
def test_guard_on_the_recurrent_state_equals_the_reference(arch, dtype):
    """The reference's decode cache after five refeed ticks (Mamba ``h`` and
    conv tails beside Jamba's KV rows; RWKV ``wkv`` and token-shift rows)
    with the tokens and position, carried across: the serving guard's coded
    shards equal the reference guard's bit for bit; after host 3 dies, the
    recovered state equals the snapshot bit for bit, and the next ticks
    resumed from it give the unfailed run's logits."""
    rm, rp, m, p = pair(arch, dtype)
    toks = np.random.default_rng(2).integers(0, V, size=(2, 8)).astype(np.int32)
    rstep = jax.jit(rm.decode_step)
    rcache = rm.init_cache(2, 12)
    for t in range(5):
        _, rcache = rstep(rp, rcache, jnp.asarray(toks[:, t:t + 1]), jnp.full((2,), t, jnp.int32))
    state = {"tokens": jnp.asarray(toks), "pos": jnp.asarray(5, jnp.int32)}
    ref = RCodedServeGuard(K=3, R=2)
    ref.snapshot(rcache, state, tick=5)
    cache, pstate = state_from_reference(jax.tree.map(np.asarray, (rcache, state)), device="cpu")
    guard = CodedServeGuard(K=3, R=2, injector=FaultInjector(kills=((5, 3),)), device="cpu")
    guard.snapshot(cache, pstate, tick=5)
    for j in range(5):
        np.testing.assert_array_equal(guard.group._mem[j], np.asarray(ref.group._mem[j]))
    assert guard.poll(5) == [] and guard.poll(6) == [3]
    back_cache, back_state = guard.recover([3])
    assert tree.structure(back_cache) == tree.structure(cache)
    assert all(bits(a) == bits(b) for a, b in zip(tree.leaves((back_cache, back_state)), tree.leaves((cache, pstate))))
    step = make_decode_step(m)
    last = []
    for c in (cache, back_cache):
        for t in range(5, 8):
            lg, c = step(p, c, torch.from_numpy(toks[:, t:t + 1]), torch.full((2,), t, dtype=torch.int32))
        last.append(lg)
    assert torch.equal(*last)


def test_checkpoint_roundtrip_bf16(tmp_path):
    """``tests/test_train_substrate.py``'s case on the port: a one-layer
    RWKV6 state with bf16 moments saved and restored bit for bit; the
    reference restores the same file to the same bits."""
    cfg = smoke_config(RWKV).replace(n_layers=1)
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(2))
    ocfg = OptConfig(moment_dtype="bfloat16")
    state = {"params": params, "opt": init_state(ocfg, params)}
    save_checkpoint(str(tmp_path / "ckpt"), state, step=42)
    restored, step = restore_checkpoint(str(tmp_path / "ckpt"), state, device="cpu")
    assert step == 42
    assert all(bits(a) == bits(b) and a.dtype == b.dtype for a, b in zip(tree.leaves(state), tree.leaves(restored)))
    rm = r_build_model(r_smoke_config(RWKV).replace(n_layers=1))
    like = jax.eval_shape(lambda: {"params": (rp := rm.init(jax.random.key(0))),
                                   "opt": r_init_state(ROptConfig(moment_dtype="bfloat16"), rp)})
    rrestored, rstep = r_restore_checkpoint(str(tmp_path / "ckpt"), like)
    assert rstep == 42
    assert all(bits(a) == bits(b) for a, b in zip(tree.leaves(state), jax.tree.leaves(rrestored)))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_the_reference(arch):
    """One AdamW step of the float32 smoke config: the losses within
    ``ATOL_LOSS_F32``, the update within ``tests/test_torch_train.py``'s
    step bound (1e-6 but for at most 2 % of a leaf, those within
    2 · lr · 1.05)."""
    rm, rp, m, p = pair(arch, "float32", seed=1)
    cfg, rcfg = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10), ROptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    b = r_make_batch(rm.cfg, 2, 16, seed=5)
    want = jax.jit(r_make_train_step(rm, rcfg))(rp, r_init_state(rcfg, rp), {k: jnp.asarray(v) for k, v in b.items()})
    got = make_train_step(m, cfg)(p, init_state(cfg, p), to_device({k: np.array(v) for k, v in b.items()}, "cpu"))
    for k in ("loss", "ce", "aux"):
        assert abs(float(got[2][k]) - float(want[2][k])) <= ATOL_LOSS_F32, k
    lr = float(got[2]["lr"])
    for name, a, r in zip(tree.flatten_with_names(p), tree.leaves(got[0]), jax.tree.leaves(want[0])):
        d = np.abs(as_np(a) - as_np(r))
        assert (d <= 2 * lr * 1.05 + 1e-6).all(), name
        assert (d > 1e-6).mean() <= 0.02, name


def test_launcher_serves_rwkv_through_the_fixed_engine_only(capsys):
    """``launch/serve.py --engine fixed`` serves RWKV6's smoke config on the
    CPU; the default continuous engine falls back to the fixed engine, as the
    reference's does, with the same tokens, and ``--coded`` (continuous only)
    ends the run."""
    argv = ["--arch", RWKV, "--smoke", "--device", "cpu", "--prompts", "1,2,3;4,5", "--max-new", "6", "--max-len", "32"]
    res = serve_main(argv + ["--engine", "fixed"])
    text = capsys.readouterr().out
    assert res.tokens.shape == (2, 9) and list(res.lengths) == [9, 8] and "on cpu" in text
    assert list(res.tokens[0, :3]) == [1, 2, 3] and list(res.tokens[1, :2]) == [4, 5]
    fell_back = serve_main(argv)
    text = capsys.readouterr().out
    assert text.startswith(f"{RWKV}-smoke: no one-pass prefill; falling back to fixed-batch\n")
    assert np.array_equal(fell_back.tokens, res.tokens)
    with pytest.raises(SystemExit, match="--coded needs the continuous engine"):
        serve_main(argv + ["--coded", "3,2"])
