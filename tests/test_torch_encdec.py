"""Differential tests of the port's encoder-decoder (Whisper) and VLM
(InternVL2) families against the JAX package on the CPU: the GELU MLP, the
sinusoidal position tables, the encoder, cross-attention, the patch prefix,
both models' forward, loss, gradients and decode, their parameter and cache
trees, the fixed engine, the serving guard on their decode state, and the
launcher's fall-back to the fixed engine.

The same numpy-seeded inputs go through ``repro.models`` and
``repro_torch.models`` (``device="cpu"``); parameters are carried across by
``repro_torch.convert.params_from_reference``, bfloat16 by its bits, which
also holds the pytree's leaf order to the reference's. Whisper's smoke
config has two decoder and two encoder layers over 8 frames; InternVL2's two
layers behind 4 patches. Tolerances, those of ``tests/test_torch_models.py``
and ``tests/test_torch_ssm.py``:

* integer and bit-level results (greedy tokens, coded shards over GF(q), a
  cache after a guard's recovery, the numpy sinusoidal table, shapes and
  dims): equal;
* float32 modules ``ATOL_F32`` (1e-5) absolute, the float32 sinusoidal rows
  of ``_sinusoidal_at`` ``ATOL_SIN`` (1e-6); bfloat16 modules within
  ``BF16_SCALE`` (2^-6) of the largest reference value;
* float32 model logits ``ATOL_LOGITS_F32`` (1e-4), the loss
  ``ATOL_LOSS_F32`` (1e-5), gradients within ``GRAD_SCALE`` (1e-5) of each
  leaf's largest reference gradient;
* decode against the teacher-forced forward, within the port: the
  reference's own tolerance (``tests/test_attention_oracle.py``, 0.2).
"""

import contextlib
import functools
import io
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.launch.serve as r_serve
from repro.configs import ARCHS as R_ARCHS
from repro.configs import smoke_config as r_smoke_config
from repro.configs.base import EncDecConfig as REncDecConfig
from repro.launch.roofline import param_counts as r_param_counts
from repro.models import build_model as r_build_model
from repro.models import layers as RL
from repro.models import make_batch as r_make_batch
from repro.models import model as RM
from repro.obs.metrics import MetricsRegistry as RMetricsRegistry
from repro.serve import CodedServeGuard as RCodedServeGuard
from repro.serve import Engine as REngine
from repro.train import save_checkpoint as r_save_checkpoint
from repro_torch import tree
from repro_torch.configs import get, smoke_config
from repro_torch.configs.base import EncDecConfig
from repro_torch.convert import params_from_reference, state_from_reference
from repro_torch.launch.roofline import param_counts
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import build_model, layers as L, make_batch
from repro_torch.models import model as M
from repro_torch.obs import MetricsRegistry
from repro_torch.serve import CodedServeGuard, ContinuousEngine, Engine, FaultInjector
from repro_torch.train import make_decode_step

ATOL_F32 = 1e-5
ATOL_SIN = 1e-6
BF16_SCALE = 2.0 ** -6
ATOL_LOGITS_F32 = 1e-4
ATOL_LOSS_F32 = 1e-5
GRAD_SCALE = 1e-5
ORACLE_TOL = 0.2  # tests/test_attention_oracle.py::test_decode_matches_forward_more_archs

WHISPER, INTERNVL = "whisper-base", "internvl2-26b"
ARCHS = [WHISPER, INTERNVL]
V = 503  # the smoke vocabulary (padded to 512)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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


def assert_logits(port, ref):
    p, r = as_np(port), as_np(ref)
    np.testing.assert_allclose(p[..., :V], r[..., :V], rtol=0, atol=ATOL_LOGITS_F32)
    np.testing.assert_array_equal(p[..., V:], r[..., V:])  # the padded columns: -1e30


def normal(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def both(a: np.ndarray, dtype: str):
    """``a`` as the reference's array and the port's tensor of ``dtype``."""
    return jnp.asarray(a, dtype=DTYPES[dtype][0]), torch.from_numpy(a).to(DTYPES[dtype][1])


def port_batch(rbatch) -> dict:
    """A reference batch (tokens, labels, frames or patches) as tensors, bf16
    by its bits."""
    return state_from_reference(jax.tree.map(np.asarray, rbatch), device="cpu")


@functools.lru_cache(maxsize=8)
def pair(arch: str, dtype: str = "float32", seed: int = 0, n_frames: int | None = None):
    """(reference model, reference params, port model, port params) of the
    smoke config (with ``n_frames`` frames where given), the parameters
    carried across."""
    rcfg, cfg = r_smoke_config(arch).replace(dtype=dtype), smoke_config(arch).replace(dtype=dtype)
    if n_frames is not None:
        rcfg = rcfg.replace(encdec=REncDecConfig(n_enc_layers=rcfg.encdec.n_enc_layers, n_frames=n_frames))
        cfg = cfg.replace(encdec=EncDecConfig(n_enc_layers=cfg.encdec.n_enc_layers, n_frames=n_frames))
    rm = r_build_model(rcfg)
    rp = rm.init(jax.random.key(seed))
    m = build_model(cfg)
    return rm, rp, m, params_from_reference(jax.tree.map(np.asarray, rp), m, device="cpu")


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_equals_the_reference(dtype):
    """The encoder's MLP (tanh GELU, biases before the activation and after
    ``w_down``): its pytree, dims and output; the biases are drawn nonzero
    here so that both additions are held."""
    d, ff = 64, 96
    rp = RL.gelu_mlp_init(jax.random.key(1), d, ff, DTYPES[dtype][0])
    rp = dict(rp, b_up=jnp.asarray(normal(2, (ff,), 0.5), DTYPES[dtype][0]),
              b_down=jnp.asarray(normal(3, (d,), 0.5), DTYPES[dtype][0]))
    p = state_from_reference(jax.tree.map(np.asarray, rp), device="cpu")
    spec = L.gelu_mlp_init(None, d, ff, DTYPES[dtype][1])
    assert tree.structure(spec) == tree.structure(p)
    assert all(t.device.type == "meta" and t.shape == q.shape and t.dtype == q.dtype
               for t, q in zip(tree.leaves(spec), tree.leaves(p)))
    made = L.gelu_mlp_init(torch.Generator().manual_seed(0), d, ff, DTYPES[dtype][1])
    assert not made["b_up"].any() and not made["b_down"].any()
    assert L.gelu_mlp_specs() == RL.gelu_mlp_specs()
    rx, x = both(normal(4, (2, 5, d), 2.0), dtype)
    assert_close(L.gelu_mlp(p, x), RL.gelu_mlp(rp, rx), dtype, atol_f32=1e-6)


@pytest.mark.parametrize("S, d", [(8, 64), (1500, 512), (37, 6)])
def test_sin_table_is_the_references_bit_for_bit(S, d):
    got = M._sin_table(S, d)
    assert got.dtype == np.float32 and got.shape == (S, d)
    assert bits(got) == bits(RM._sin_table(S, d))
    assert bits(M._sinusoidal(S, d, "cpu")) == bits(np.asarray(RM._sinusoidal(S, d)))


@pytest.mark.parametrize("d", [64, 512])
def test_sinusoidal_at_equals_the_reference(d):
    """Every position a decode cache of 4,096 rows can hold, in a shuffled
    order."""
    pos = np.random.default_rng(0).permutation(4096).astype(np.int32)
    got = M._sinusoidal_at(torch.from_numpy(pos), d)
    want = RM._sinusoidal_at(jnp.asarray(pos), d)
    assert got.dtype == torch.float32 and got.shape == (4096, d)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=0, atol=ATOL_SIN)


@pytest.mark.parametrize("n_frames", [8, 1100])
def test_encode_frames_equals_the_reference(n_frames):
    """The encoder over ``n_frames`` stub frames (1100: two KV chunks of
    1024, the second padded and masked) at float32."""
    rm, rp, m, p = pair(WHISPER, n_frames=n_frames)
    rf, f = both(normal(5, (2, n_frames, 64), 0.5), "float32")
    got = m._encode_frames(p, f)
    want = rm._encode_frames(rp, rf, RL.NO_CTX)
    assert got.shape == (2, n_frames, 64)
    assert_close(got, want, "float32")


def test_cross_attention_equals_the_reference():
    """One decoder cross-attention block of 5 queries onto 8 encoder rows
    (Sq ≠ Sk), no mask, no RoPE."""
    rm, rp, m, p = pair(WHISPER)
    rcp = jax.tree.map(lambda a: a[1], rp["encoder"]["cross"])
    cp = tree.map(lambda t: t[1], p["encoder"]["cross"])
    rx, x = both(normal(6, (2, 5, 64)), "float32")
    renc, enc = both(normal(7, (2, 8, 64)), "float32")
    got = m._cross_attn(cp, x, enc)
    assert got.shape == (2, 5, 64)
    assert_close(got, rm._cross_attn(rcp, rx, renc, rm.cfg, RL.NO_CTX), "float32")


# ---------------------------------------------------------------------------
# the models: build, pattern, params, caches
# ---------------------------------------------------------------------------


def names_of(rtree) -> list[str]:
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(rtree)[0]]


@pytest.mark.parametrize("arch", ARCHS)
def test_params_dims_and_cache_carry_across_in_the_reference_leaf_order(arch):
    """The pattern, the parameters' pytree (shapes, dtypes, leaf order: the
    ``encoder`` leaves between ``embed`` and ``lm_head``), the logical dims
    of parameters and cache, and ``init_cache``'s leaves (Whisper's
    ``enc_out`` among them) equal the reference's."""
    rm, rp, m, p = pair(arch, "bfloat16")
    assert (m.prefix, m.body, m.repeats) == (rm.prefix, rm.body, rm.repeats) == ([], ["dense"], 2)
    assert (m.is_encdec, m.is_vlm) == (rm.is_encdec, rm.is_vlm) == (arch == WHISPER, arch == INTERNVL)
    assert tree.structure(p) == tree.structure(m.param_specs()) == tree.structure(rp)
    assert list(tree.flatten_with_names(p)) == names_of(rp)
    tops = list(dict.fromkeys(k.split("/")[0] for k in tree.flatten_with_names(p)))
    assert tops == (["body", "embed", "encoder", "lm_head", "ln_f"] if arch == WHISPER
                    else ["body", "embed", "lm_head", "ln_f"])
    for got, want in zip(tree.leaves(p), jax.tree.leaves(rp)):
        assert tuple(got.shape) == want.shape and str(want.dtype) in str(got.dtype)
    assert m.param_dims() == rm.param_specs()[1]
    assert m.cache_dims() == rm.cache_dims()
    rc, c = rm.init_cache(3, 10), m.init_cache(3, 10, device="cpu")
    assert tree.structure(c) == tree.structure(rc)
    assert list(tree.flatten_with_names(c)) == names_of(rc)
    for got, want in zip(tree.leaves(c), jax.tree.leaves(rc)):
        assert tuple(got.shape) == want.shape and str(want.dtype) in str(got.dtype) and not got.any()
    assert ("enc_out" in c) == (arch == WHISPER)
    if arch == WHISPER:
        assert tuple(c["enc_out"].shape) == (3, 8, 64) and m.cache_dims()["enc_out"] == ("batch", "frames", "d_model")
    assert not m.supports_prefill and not rm.supports_prefill


@pytest.mark.parametrize("arch, weights, tick, cache", [
    (WHISPER, 207_176_704, 116_155_392, 31_309_824),
    (INTERNVL, 39_725_445_120, 38_586_691_584, 402_653_184),
])
def test_full_width_param_specs_dims_and_bytes(arch, weights, tick, cache):
    """Whole, at full width: every leaf's shape and dtype and the logical
    dims equal the reference's ``param_specs``; the model holds ``weights``
    bytes of bf16 weights, all but ``embed``, the encoder's layers and
    ``ln_post`` (what a decode tick reads: the cross-attention blocks
    included) ``tick`` bytes, and its decode cache at 4 rows × 512 positions ``cache``
    bytes (Whisper's ``enc_out`` in it)."""
    m = build_model(get(arch))
    rm = r_build_model(R_ARCHS[arch])
    rshapes, rdims = rm.param_specs()
    spec = m.param_specs()
    assert tree.structure(spec) == tree.structure(rshapes)
    for (name, got), want in zip(tree.flatten_with_names(spec).items(), jax.tree.leaves(rshapes)):
        assert got.device.type == "meta" and tuple(got.shape) == want.shape and str(want.dtype) in str(got.dtype), name
    assert m.param_dims() == rdims
    assert m.cache_dims() == rm.cache_dims()
    by = lambda t: sum(x.numel() * x.element_size() for x in tree.leaves(t))  # noqa: E731
    enc = by({k: v for k, v in spec["encoder"].items() if k != "cross"}) if arch == WHISPER else 0
    assert (by(spec), by(spec) - by(spec["embed"]) - enc, by(m.init_cache(4, 512, device="meta"))) == \
        (weights, tick, cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_the_reference_and_the_leaves(arch):
    """``launch.roofline.param_counts`` equals the reference's, smoke and full
    width, and counts every leaf of the port's model but the norms' scales
    and biases and the MLP biases."""
    for cfg, rcfg in ((smoke_config(arch), r_smoke_config(arch)), (get(arch), R_ARCHS[arch])):
        assert param_counts(cfg) == r_param_counts(rcfg)
        names = tree.flatten_with_names(build_model(cfg).param_specs())
        n = sum(t.numel() for k, t in names.items() if k.split("/")[-1] not in ("scale", "bias", "b_up", "b_down"))
        assert n == param_counts(cfg)["total"] == param_counts(cfg)["active"]


def test_init_draws_the_encoder_after_the_body():
    """``Model.init`` draws the encoder after the body (the reference's key
    order), so Whisper's embed, lm_head and body hold what the same config
    without an encoder draws; the encoder's norms are ones and zeros and its
    MLP biases zeros, in every stacked layer; the draws repeat from a seed."""
    cfg = smoke_config(WHISPER)
    m = build_model(cfg)
    made = tree.flatten_with_names(m.init(torch.Generator().manual_seed(3)))
    again = tree.flatten_with_names(m.init(torch.Generator().manual_seed(3)))
    plain = tree.flatten_with_names(build_model(cfg.replace(encdec=None)).init(torch.Generator().manual_seed(3)))
    assert all(bits(made[k]) == bits(again[k]) for k in made)
    assert sorted(k for k in made if not k.startswith("encoder/")) == sorted(plain)
    assert all(bits(made[k]) == bits(plain[k]) for k in plain)
    for k, t in made.items():
        if k.startswith("encoder/"):
            leaf = k.split("/")[-1]
            lead = {"layers": 2, "cross": 2, "ln_post": None}[k.split("/")[1]]
            assert lead is None or t.shape[0] == lead, k
            if leaf == "scale":
                assert bool((t == 1).all()), k
            elif leaf in ("bias", "b_up", "b_down"):
                assert not t.any(), k
            else:
                assert float(t.float().std()) > 0.01, k


# ---------------------------------------------------------------------------
# forward, loss, gradients, decode
# ---------------------------------------------------------------------------


def seq_len(m, text: int) -> int:
    return text + (m.cfg.vlm.n_patches if m.is_vlm else 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss(arch):
    """float32 ``forward`` over the reference's batch (frames or patches),
    the logits of the text positions, and ``loss``."""
    rm, rp, m, p = pair(arch)
    rb = r_make_batch(rm.cfg, 2, seq_len(m, 12), seed=5)
    b = port_batch(rb)
    logits, aux, h = m.forward(p, b)
    rlogits, raux, rh = jax.jit(rm.forward)(rp, rb)
    assert logits.shape == (2, 12, 512)
    assert_logits(logits, rlogits)
    assert_close(h, rh, "float32")
    loss, metrics = m.loss(p, b)
    _, rmet = jax.jit(rm.loss)(rp, rb)
    for k in ("loss", "ce", "aux"):
        assert abs(float(metrics[k]) - float(rmet[k])) <= ATOL_LOSS_F32, k


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients(arch):
    """The gradients of the float32 loss (a fifth of the labels masked) with
    respect to every leaf, the encoder's among them."""
    rm, rp, m, p = pair(arch)
    rb = dict(r_make_batch(rm.cfg, 2, seq_len(m, 10), seed=3))
    labels = np.asarray(rb["labels"]).copy()
    labels[:, ::5] = -1
    rb["labels"] = jnp.asarray(labels)
    (rl, rmet), rg = jax.jit(jax.value_and_grad(lambda pp: rm.loss(pp, rb), has_aux=True))(rp)
    leaves, treedef = tree.flatten(p)
    live = [t.detach().requires_grad_(True) for t in leaves]
    loss, metrics = m.loss(tree.unflatten(treedef, live), port_batch(rb))
    grads = torch.autograd.grad(loss, live)
    assert abs(float(loss.detach()) - float(rl)) <= ATOL_LOSS_F32
    for name, g, r in zip(tree.flatten_with_names(p), grads, jax.tree.leaves(rg)):
        r = as_np(r)
        np.testing.assert_allclose(as_np(g), r, rtol=0, atol=GRAD_SCALE * float(np.abs(r).max()), err_msg=name)


def test_remat_is_not_applied_to_the_encoder_decoder(monkeypatch):
    """The reference's encoder-decoder branch applies no remat: under
    ``remat="block"`` with autograd on, Whisper never checkpoints, the VLM
    (the plain branch) does once a layer; the gradients are the same."""
    calls = []
    real = M.checkpoint
    monkeypatch.setattr(M, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    for arch in ARCHS:
        _, _, m, p = pair(arch)
        rb = r_make_batch(m.cfg, 1, seq_len(m, 6), seed=4)
        grads = []
        for remat in ("none", "block"):
            model = build_model(m.cfg.replace(remat=remat))
            leaves, treedef = tree.flatten(p)
            live = [t.detach().requires_grad_(True) for t in leaves]
            calls.clear()
            loss, _ = model.loss(tree.unflatten(treedef, live), port_batch(rb))
            grads.append(torch.autograd.grad(loss, live))
            assert len(calls) == (2 if remat == "block" and arch == INTERNVL else 0), (arch, remat)
        assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_and_cache(arch):
    """Eight float32 ``decode_step``s of three rows (Whisper over a nonzero
    ``enc_out``): the logits and the cache, written in place, equal the
    reference's."""
    rm, rp, m, p = pair(arch)
    B, smax = 3, 16
    rcache, cache = rm.init_cache(B, smax), m.init_cache(B, smax, device="cpu")
    if m.is_encdec:
        renc, enc = both(normal(8, (B, 8, 64)), "float32")
        rcache = dict(rcache, enc_out=renc)
        cache["enc_out"].copy_(enc)
    held = tree.leaves(cache)
    toks = np.random.default_rng(1).integers(0, V, size=(B, 8)).astype(np.int32)
    step, rstep = make_decode_step(m), jax.jit(rm.decode_step)
    for t in range(8):
        pos = np.array([t, 2 * t, 7], np.int32)
        lg, out = step(p, cache, torch.from_numpy(toks[:, t:t + 1]), torch.from_numpy(pos))
        rlg, rcache = rstep(rp, rcache, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos))
        assert out is cache
        assert_logits(lg, rlg)
    assert all(a is b for a, b in zip(tree.leaves(cache), held))
    for got, want in zip(tree.leaves(cache), jax.tree.leaves(rcache)):
        assert_close(got, want, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """``tests/test_attention_oracle.py::test_decode_matches_forward_more_archs``
    on the port (bf16, its batch, its tolerance): Whisper's decode over the
    encoded frames reproduces the teacher-forced forward. The reference skips
    the VLM's comparison (its decode carries no patch prefix); here the VLM's
    decode is held against its forward with no patches."""
    rm, _, m, p = pair(arch, "bfloat16")
    B, S = 2, 8
    batch = make_batch(m.cfg, B, seq_len(m, S), seed=6, device="cpu")
    np.testing.assert_array_equal(batch["tokens"].numpy(),
                                  np.asarray(r_make_batch(rm.cfg, B, seq_len(m, S), seed=6)["tokens"]))
    if m.is_vlm:
        batch["patches"] = batch["patches"][:, :0]
    full, _, _ = m.forward(p, batch)
    cache = m.init_cache(B, S, device="cpu")
    if m.is_encdec:
        cache["enc_out"].copy_(m._encode_frames(p, batch["frames"].to(m.dtype)))
        assert cache["enc_out"].abs().max() > 0.5
    for t in range(S):
        lg, cache = m.decode_step(p, cache, batch["tokens"][:, t:t + 1], torch.full((B,), t, dtype=torch.int32))
        np.testing.assert_allclose(as_np(lg[:, 0, :V]), as_np(full[:, t, :V]), rtol=ORACLE_TOL, atol=ORACLE_TOL)


# ---------------------------------------------------------------------------
# serving, the guard and the launcher
# ---------------------------------------------------------------------------

PROMPTS = [[5, 9, 2, 7, 1], [3, 3, 8], [11, 4, 6, 2, 9, 10, 1]]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_unsupported_the_continuous_engine_refuses(arch):
    _, _, m, p = pair(arch)
    assert not m.supports_prefill
    with pytest.raises(NotImplementedError):
        ContinuousEngine(m, p, n_slots=2, max_len=32)
    with pytest.raises(NotImplementedError):
        m.prefill_into_cache(p, m.init_cache(1, 8, device="cpu"), torch.zeros((1, 8), dtype=torch.int32), 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_fixed_engine_greedy_tokens_equal_the_reference(arch):
    """float32: the fixed engine's greedy tokens (Whisper over the zeroed
    stub ``enc_out``, as the reference's engine zeroes it) equal the
    reference engine's."""
    rm, rp, m, p = pair(arch)
    got = Engine(m, p, max_len=24, metrics=MetricsRegistry()).generate(PROMPTS, max_new_tokens=6)
    want = REngine(rm, rp, max_len=24, metrics=RMetricsRegistry()).generate(PROMPTS, max_new_tokens=6)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths, want.lengths)


@pytest.mark.parametrize("arch", ARCHS)
def test_guard_on_the_decode_cache_equals_the_reference(arch):
    """The reference's bf16 decode cache after five refeed ticks (Whisper's
    with a nonzero ``enc_out``, the encoder's output) with the tokens and
    position, carried across: the serving guard's coded shards equal the
    reference guard's bit for bit; after host 3 dies, the recovered state
    equals the snapshot bit for bit, and the next ticks resumed from it give
    the unfailed run's logits."""
    rm, rp, m, p = pair(arch, "bfloat16")
    toks = np.random.default_rng(2).integers(0, V, size=(2, 8)).astype(np.int32)
    rstep = jax.jit(rm.decode_step)
    rcache = rm.init_cache(2, 12)
    if rm.is_encdec:
        frames = jnp.asarray(normal(9, (2, 8, 64), 0.5), jnp.bfloat16)
        rcache = dict(rcache, enc_out=rm._encode_frames(rp, frames, RL.NO_CTX))
    for t in range(5):
        _, rcache = rstep(rp, rcache, jnp.asarray(toks[:, t:t + 1]), jnp.full((2,), t, jnp.int32))
    state = {"tokens": jnp.asarray(toks), "pos": jnp.asarray(5, jnp.int32)}
    ref = RCodedServeGuard(K=3, R=2)
    ref.snapshot(rcache, state, tick=5)
    cache, pstate = state_from_reference(jax.tree.map(np.asarray, (rcache, state)), device="cpu")
    assert tree.structure(cache) == tree.structure(m.init_cache(2, 12, device="cpu"))
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


LAUNCH_ARCHS = ["rwkv6-3b", "jamba-v0.1-52b", WHISPER, INTERNVL]
LAUNCH_ARGV = ["--smoke", "--prompts", "1,2,3;4,5", "--max-new", "6", "--max-len", "32"]


def reference_launcher(argv, monkeypatch) -> list[str]:
    """The reference ``launch/serve.py``'s ``main`` on the JAX CPU backend
    with ``argv``; the lines it printed."""
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        r_serve.main()
    return out.getvalue().splitlines()


@pytest.mark.parametrize("arch", LAUNCH_ARCHS)
def test_launcher_default_engine_falls_back_to_fixed_as_the_reference(arch, tmp_path, monkeypatch, capsys):
    """A model with no one-pass prefill (recurrent, encoder-decoder, VLM):
    the launcher's default ``--engine continuous`` prints the reference's
    fall-back line and serves through the fixed engine, with the tokens of
    ``--engine fixed`` and of the reference launcher, both reading the
    reference's bf16 weights from one checkpoint; ``--coded`` ends the run
    there, as in the reference. The launcher serves bf16 only, and bf16
    greedy tokens of the two packages can part at a near-tie (RWKV6's smoke
    model does on a third prompt ``7,7,7,7,7`` at its fourth new token);
    token equality across the packages is held at float32 by
    ``test_fixed_engine_greedy_tokens_equal_the_reference``."""
    rm = r_build_model(r_smoke_config(arch))
    ck = str(tmp_path / "ck")
    r_save_checkpoint(ck, rm.init(jax.random.key(0)), step=1)
    argv = ["--arch", arch, "--ckpt", ck, *LAUNCH_ARGV]
    want = reference_launcher(argv, monkeypatch)
    capsys.readouterr()
    res = serve_main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    fixed = serve_main(argv + ["--device", "cpu", "--engine", "fixed"])
    capsys.readouterr()
    line = f"{arch}-smoke: no one-pass prefill; falling back to fixed-batch"
    assert got[0] == want[0] == line
    assert [s for s in got if s.startswith("seq ")] == [s for s in want if s.startswith("seq ")]
    assert res.tokens.shape == (2, 9) and np.array_equal(res.tokens, fixed.tokens)
    for serve in (lambda a: reference_launcher(a, monkeypatch), lambda a: serve_main(a + ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="--coded needs the continuous engine"):
            serve(argv + ["--coded", "3,2"])
