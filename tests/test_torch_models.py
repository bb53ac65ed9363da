"""Differential tests of the port's dense model (``repro_torch.configs``,
``repro_torch.models``) against the JAX package on the CPU.

The same numpy-seeded inputs go through ``repro.models`` and
``repro_torch.models`` (``device="cpu"``); parameters are carried across by
``repro_torch.convert.params_from_reference``, bfloat16 by its bits. The
arithmetic is float, and XLA and PyTorch sum in different orders, so every
comparison states its tolerance:

* float32 modules: ``ATOL_F32`` (1e-5) absolute; float32 model logits
  ``ATOL_LOGITS_F32`` (1e-4, what the port is held to; PyTorch 2.13 on the CPU
  measured 4e-7);
* bfloat16 modules: within ``BF16_SCALE`` (2^-6, four bf16 ulps) of the largest
  reference value in absolute terms — the two packages round bf16
  intermediates at different points (SiLU, the GQA products), and a matmul
  that sums such values cancels to small outputs; bfloat16 model logits within ``ATOL_LOGITS_BF16``
  (3e-2 absolute on logits of magnitude below 1; measured 8e-3) — one bf16
  rounding that differs early propagates through the layers;
* integer and bookkeeping results (configs, batches, cache rows that no
  computation touches, parameter trees): equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as R_ARCHS
from repro.configs import smoke_config as r_smoke_config
from repro.models import build_model as r_build_model
from repro.models import layers as RL
from repro.models.inputs import batch_dims as r_batch_dims
from repro.models.inputs import make_batch as r_make_batch
from repro.models.model import layer_pattern as r_layer_pattern
from repro_torch import tree
from repro_torch.configs import ARCHS, SHAPES, get, shape_applicable, smoke_config
from repro_torch.convert import params_from_reference, state_from_reference
from repro_torch.models import NO_CTX, batch_dims, build_model, layers as L, make_batch
from repro_torch.models.model import layer_pattern
from repro_torch.train import make_ctx, make_decode_step, make_prefill_step

ATOL_F32 = 1e-5
ATOL_LOGITS_F32 = 1e-4
BF16_SCALE = 2.0 ** -6
ATOL_LOGITS_BF16 = 3e-2

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def rng_array(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def to_jax(a: np.ndarray, dtype: str):
    return jnp.asarray(a, dtype=DTYPES[dtype][0])


def to_torch(a: np.ndarray, dtype: str):
    return torch.from_numpy(a).to(DTYPES[dtype][1])


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def assert_close(port, ref, dtype: str, atol_f32: float = ATOL_F32):
    p, r = as_np(port), as_np(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    if dtype == "float32":
        np.testing.assert_allclose(p, r, rtol=0, atol=atol_f32)
    else:
        np.testing.assert_allclose(p, r, rtol=0, atol=BF16_SCALE * float(np.abs(r).max()))


def smoke_pair(dtype: str = "float32", n_layers: int = 2, seed: int = 0):
    """(reference model, reference params, port model, port params) of the
    Qwen3-1.7B smoke config at ``dtype``, the parameters carried across."""
    rcfg = r_smoke_config("qwen3-1.7b").replace(dtype=dtype, n_layers=n_layers)
    rm = r_build_model(rcfg)
    rp = rm.init(jax.random.key(seed))
    cfg = smoke_config("qwen3-1.7b").replace(dtype=dtype, n_layers=n_layers)
    m = build_model(cfg)
    return rm, rp, m, params_from_reference(jax.tree.map(np.asarray, rp), m, device="cpu")


# ---------------------------------------------------------------------------
# configs and inputs
# ---------------------------------------------------------------------------


def test_registry_knows_every_reference_config():
    assert list(ARCHS) == list(R_ARCHS)
    for name, cfg in R_ARCHS.items():
        assert dataclasses.asdict(get(name)) == dataclasses.asdict(cfg), name
    with pytest.raises(KeyError, match="unknown arch"):
        get("no-such-model")
    assert sorted(SHAPES) == ["decode_32k", "long_500k", "prefill_32k", "train_4k"]
    ok, why = shape_applicable(get("qwen3-1.7b"), SHAPES["long_500k"])
    assert not ok and "sub-quadratic" in why


@pytest.mark.parametrize("arch", sorted(R_ARCHS))
def test_smoke_config_and_layer_pattern_equal_the_reference(arch):
    cfg, rcfg = smoke_config(arch), r_smoke_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert cfg.vocab_padded == rcfg.vocab_padded == 512
    assert layer_pattern(cfg) == r_layer_pattern(rcfg)
    assert layer_pattern(get(arch)) == r_layer_pattern(R_ARCHS[arch])


@pytest.mark.parametrize("arch", sorted(set(R_ARCHS) - {"qwen3-1.7b", "qwen1.5-32b", "deepseek-coder-33b",
                                                        "internlm2-20b", "arctic-480b"}))
def test_build_model_refuses_families_not_ported(arch):
    """Every family not ported is refused, naming ROADMAP.md queue A4; since
    MLA and MTP are ported, DeepSeek-V3 builds instead."""
    if arch == "deepseek-v3-671b":
        m = build_model(smoke_config(arch))
        assert (m.prefix, m.body, m.repeats) == (["mla_dense"], ["mla_moe"], 1) and "mtp" in m.param_specs()
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A4"):
        build_model(smoke_config(arch))


@pytest.mark.parametrize("arch, item", [("jamba-v0.1-52b", r"A4\.3 \(Mamba"), ("deepseek-v3-671b", r"A4\.2 \(MLA\)")])
def test_build_model_refuses_hybrid_moe_and_mla(arch, item):
    """MoE is ported (``arctic-480b``), but a hybrid MoE pattern (Jamba's
    Mamba layers) is not: it is refused, naming its item of ROADMAP.md queue
    A4. MLA (A4.2) and MTP are ported since: DeepSeek-V3 builds, at full
    width too."""
    if arch == "deepseek-v3-671b":
        assert build_model(smoke_config(arch)).prefix == ["mla_dense"]
        m = build_model(get(arch))
        assert (len(m.prefix), m.body, m.repeats) == (3, ["mla_moe"], 58)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A4: .*" + item):
        build_model(smoke_config(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A4"):
        build_model(get(arch))
    assert build_model(smoke_config("arctic-480b")).body == ["moe"]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "internvl2-26b", "whisper-base"])
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_make_batch_and_batch_dims_equal_the_reference(arch, kind):
    cfg = smoke_config(arch)
    S = 12 if cfg.vlm is None else cfg.vlm.n_patches + 12
    got, want = make_batch(cfg, 3, S, seed=5, device="cpu"), r_make_batch(r_smoke_config(arch), 3, S, seed=5)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == (torch.int32 if k in ("tokens", "labels") else torch.bfloat16)
        np.testing.assert_array_equal(as_np(got[k]), as_np(want[k]))
    assert batch_dims(cfg, kind) == r_batch_dims(r_smoke_config(arch), kind)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_layernorm(dtype):
    x = rng_array(1, (2, 5, 64))
    scale, bias = rng_array(2, (64,)), rng_array(3, (64,), 0.1)
    got = L.rmsnorm({"scale": to_torch(scale, dtype)}, to_torch(x, dtype))
    want = RL.rmsnorm({"scale": to_jax(scale, dtype)}, to_jax(x, dtype))
    assert got.dtype == DTYPES[dtype][1]
    assert_close(got, want, dtype)
    got = L.layernorm({"scale": to_torch(scale, dtype), "bias": to_torch(bias, dtype)}, to_torch(x, dtype))
    want = RL.layernorm({"scale": to_jax(scale, dtype), "bias": to_jax(bias, dtype)}, to_jax(x, dtype))
    assert_close(got, want, dtype)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_angles_and_rotation(theta):
    pos = np.array([[0, 1, 5, 100, 1023]], dtype=np.int32)
    cos, sin = L.rope_angles(torch.from_numpy(pos), 16, theta)
    rcos, rsin = RL.rope_angles(jnp.asarray(pos), 16, theta)
    assert cos.dtype == torch.float32 and cos.shape == (1, 5, 8)
    np.testing.assert_allclose(cos.numpy(), np.asarray(rcos), rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(sin.numpy(), np.asarray(rsin), rtol=0, atol=ATOL_F32)
    x = rng_array(4, (1, 5, 3, 16))
    got = L.apply_rope(torch.from_numpy(x), cos[:, :, None], sin[:, :, None])
    want = RL.apply_rope(jnp.asarray(x), rcos[:, :, None], rsin[:, :, None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL_F32)
    # halves rotate (not interleaved pairs): element 0 pairs with element 8
    one = np.zeros((1, 1, 1, 16), np.float32)
    one[..., 0] = 1.0
    c, s = L.rope_angles(torch.tensor([[3]]), 16, theta)
    out = L.apply_rope(torch.from_numpy(one), c[:, :, None], s[:, :, None]).numpy()
    assert out[0, 0, 0, 0] == pytest.approx(float(c[0, 0, 0])) and out[0, 0, 0, 8] == pytest.approx(float(s[0, 0, 0]))


@pytest.mark.parametrize(
    "Sq, Sk, q_offset, chunk, causal",
    [(5, 5, 0, 1024, True),      # one chunk
     (20, 20, 0, 8, True),       # several Q and KV chunks, ragged last ones
     (7, 19, 12, 8, True),       # ragged Sk, q_offset (prefill continuation)
     (9, 13, 0, 4, False)],      # not causal: only the KV padding is masked
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_causal_attention(Sq, Sk, q_offset, chunk, causal, dtype):
    q, k, v = rng_array(5, (2, 4, Sq, 16)), rng_array(6, (2, 2, Sk, 16)), rng_array(7, (2, 2, Sk, 16))
    kw = dict(chunk_q=chunk, chunk_k=chunk, causal=causal, q_offset=q_offset)
    got = L.chunked_causal_attention(to_torch(q, dtype), to_torch(k, dtype), to_torch(v, dtype), **kw)
    want = RL.chunked_causal_attention(to_jax(q, dtype), to_jax(k, dtype), to_jax(v, dtype), **kw)
    assert got.dtype == DTYPES[dtype][1]
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_masks_beyond_pos(dtype):
    q, kc, vc = rng_array(8, (3, 4, 1, 16)), rng_array(9, (3, 2, 12, 16)), rng_array(10, (3, 2, 12, 16))
    pos = np.array([0, 5, 11])
    mask = np.arange(12)[None, :] <= pos[:, None]
    got = L.decode_attention(to_torch(q, dtype), to_torch(kc, dtype), to_torch(vc, dtype), torch.from_numpy(mask))
    want = RL.decode_attention(to_jax(q, dtype), to_jax(kc, dtype), to_jax(vc, dtype), jnp.asarray(mask))
    assert_close(got, want, dtype)
    # a row at pos 0 attends its first entry only: the output is that v row
    np.testing.assert_allclose(as_np(got)[0, :, 0], as_np(to_torch(vc, dtype))[0].repeat(2, axis=0)[:, 0],
                               rtol=0, atol=ATOL_F32 if dtype == "float32" else BF16_SCALE)


def test_scatter_time_writes_each_row_at_its_position():
    cache = rng_array(11, (3, 6, 2, 4))
    new = rng_array(12, (3, 1, 2, 4))
    pos = np.array([0, 5, 2], dtype=np.int32)
    t = torch.from_numpy(cache.copy())
    got = L._scatter_time(t, torch.from_numpy(new), torch.from_numpy(pos))
    want = RL._scatter_time(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(pos))
    assert got is t  # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu(dtype):
    p = {k: rng_array(13 + i, s, 0.1) for i, (k, s) in enumerate(
        (("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64))))}
    x = rng_array(20, (2, 5, 64))
    got = L.swiglu({k: to_torch(a, dtype) for k, a in p.items()}, to_torch(x, dtype))
    want = RL.swiglu({k: to_jax(a, dtype) for k, a in p.items()}, to_jax(x, dtype))
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_block_forward_and_decode(dtype):
    cfg = smoke_config("qwen3-1.7b").replace(dtype=dtype)
    rcfg = r_smoke_config("qwen3-1.7b").replace(dtype=dtype)
    rp = RL.attention_init(jax.random.key(3), rcfg, DTYPES[dtype][0])
    p = state_from_reference(jax.tree.map(np.asarray, rp), device="cpu")
    x = rng_array(21, (2, 7, 64))
    y, (k, v) = L.attention_fwd(p, to_torch(x, dtype), cfg)
    ry, (rk, rv) = RL.attention_fwd(rp, to_jax(x, dtype), rcfg)
    for got, want in ((y, ry), (k, rk), (v, rv)):
        assert_close(got, want, dtype)
    cache = {"k": to_torch(rng_array(22, (2, 9, 2, 16)), dtype), "v": to_torch(rng_array(23, (2, 9, 2, 16)), dtype)}
    rcache = {n: to_jax(as_np(t), dtype) for n, t in cache.items()}
    pos = np.array([3, 8], np.int32)
    y, cache = L.attention_decode(p, to_torch(x[:, :1], dtype), cfg, cache, torch.from_numpy(pos))
    ry, rcache = RL.attention_decode(rp, to_jax(x[:, :1], dtype), rcfg, rcache, jnp.asarray(pos))
    assert_close(y, ry, dtype)
    for n in ("k", "v"):
        assert_close(cache[n], rcache[n], dtype)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_params_from_reference_keeps_the_stacked_tree_and_bf16_bits():
    rm, rp, m, p = smoke_pair("bfloat16")
    assert tree.structure(p) == tree.structure(m.param_specs()) == tree.structure(rp)
    for got, want in zip(tree.leaves(p), jax.tree.leaves(rp)):
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))
    assert p["body"]["b0"]["attn"]["wq"].shape == (2, 64, 64)  # (n_layers, d_model, heads·head_dim)
    mine = m.init(torch.Generator().manual_seed(0))
    assert [(tuple(a.shape), a.dtype) for a in tree.leaves(mine)] == \
        [(tuple(a.shape), a.dtype) for a in tree.leaves(m.param_specs())]
    wrong = jax.tree.map(np.asarray, rp)
    wrong["ln_f"]["scale"] = wrong["ln_f"]["scale"][:-1]
    with pytest.raises(ValueError, match="ln_f/scale"):
        params_from_reference(wrong, m, device="cpu")
    del wrong["ln_f"]
    with pytest.raises(ValueError, match="not the model's"):
        params_from_reference(wrong, m, device="cpu")


def test_init_is_seeded_and_truncated():
    m = build_model(smoke_config("qwen3-1.7b"))
    a, b = m.init(torch.Generator().manual_seed(7)), m.init(torch.Generator().manual_seed(7))
    assert all(torch.equal(x, y) for x, y in zip(tree.leaves(a), tree.leaves(b)))
    w = a["body"]["b0"]["mlp"]["w_up"].float()
    assert float(w.abs().max()) <= 0.04 * (1 + 2.0 ** -7) and 0.01 < float(w.std()) < 0.02  # 2σ, bf16-rounded
    assert torch.equal(a["ln_f"]["scale"], torch.ones(64, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits(dtype):
    rm, rp, m, p = smoke_pair(dtype)
    toks = np.random.default_rng(0).integers(0, 503, size=(2, 37)).astype(np.int32)
    logits, aux, h = m.forward(p, {"tokens": torch.from_numpy(toks)})
    rlogits, raux, rh = rm.forward(rp, {"tokens": jnp.asarray(toks)})
    assert logits.dtype == torch.float32 and logits.shape == (2, 37, 512)
    atol = ATOL_LOGITS_F32 if dtype == "float32" else ATOL_LOGITS_BF16
    np.testing.assert_allclose(logits.numpy()[..., :503], np.asarray(rlogits)[..., :503], rtol=0, atol=atol)
    # the padded vocabulary is masked with -1e30 in float32
    np.testing.assert_array_equal(logits.numpy()[..., 503:], np.asarray(rlogits)[..., 503:])
    assert float(aux) == float(raux) == 0.0
    assert m(p, {"tokens": torch.from_numpy(toks)})[0].shape == logits.shape  # nn.Module call


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_logits_and_cache(dtype):
    rm, rp, m, p = smoke_pair(dtype)
    B, smax = 3, 16
    rcache, cache = rm.init_cache(B, smax), m.init_cache(B, smax, device="cpu")
    assert tree.structure(cache) == tree.structure(rcache)
    toks = np.random.default_rng(1).integers(0, 503, size=(B, 6)).astype(np.int32)
    step = make_decode_step(m)
    atol = ATOL_LOGITS_F32 if dtype == "float32" else ATOL_LOGITS_BF16
    for t in range(6):
        pos = np.full((B,), t, np.int32)
        pos[2] = min(2 * t, smax - 1)  # slots at different positions
        lg, cache = step(p, cache, torch.from_numpy(toks[:, t:t + 1]), torch.from_numpy(pos))
        rlg, rcache = rm.decode_step(rp, rcache, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos))
        np.testing.assert_allclose(lg.numpy()[..., :503], np.asarray(rlg)[..., :503], rtol=0, atol=atol)
    for got, want in zip(tree.leaves(cache), jax.tree.leaves(rcache)):
        assert_close(got, want, dtype, atol_f32=ATOL_F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plen, bucket", [(5, 8), (8, 8), (13, 16)])
def test_prefill_into_cache_logits_and_slot(dtype, plen, bucket):
    rm, rp, m, p = smoke_pair(dtype)
    prompt = np.random.default_rng(plen).integers(1, 503, size=plen).astype(np.int32)
    tb = np.zeros((1, bucket), np.int32)
    tb[0, :plen] = prompt
    cache = m.init_cache(3, 32, device="cpu")
    logits, cache = m.prefill_into_cache(p, cache, torch.from_numpy(tb), 1)
    rlogits, rcache = rm.prefill_into_cache(rp, rm.init_cache(3, 32), jnp.asarray(tb), 1)
    atol = ATOL_LOGITS_F32 if dtype == "float32" else ATOL_LOGITS_BF16
    np.testing.assert_allclose(logits.numpy()[..., :503], np.asarray(rlogits)[..., :503], rtol=0, atol=atol)
    for got, want in zip(tree.leaves(cache), jax.tree.leaves(rcache)):
        assert_close(got, want, dtype)
        assert not got[:, [0, 2]].any()  # the other slots untouched
    last, _ = make_prefill_step(m, into_cache=True)(p, m.init_cache(3, 32, device="cpu"), torch.from_numpy(tb),
                                                    1, plen)
    assert torch.equal(last, logits[:, plen - 1])


def test_prefill_equals_its_own_refeed():
    """The port's one-pass prefill writes the prompt rows that the per-token
    refeed through ``decode_step`` writes (float32, within ``ATOL_F32``),
    into the right slot and nowhere else, and gives the refeed's first token."""
    _, _, m, p = smoke_pair("float32")
    B, smax, bucket = 3, 32, 8
    prompt = [5, 9, 2, 7, 1]
    plen = len(prompt)
    step = make_decode_step(m)
    refeed = m.init_cache(B, smax, device="cpu")
    for t in range(plen):
        toks = torch.zeros((B, 1), dtype=torch.int32)
        toks[1, 0] = prompt[t]
        lg_r, refeed = step(p, refeed, toks, torch.full((B,), t, dtype=torch.int32))
    tb = torch.zeros((1, bucket), dtype=torch.int32)
    tb[0, :plen] = torch.tensor(prompt)
    last, pf = make_prefill_step(m, into_cache=True)(p, m.init_cache(B, smax, device="cpu"), tb, 1, plen)
    for r, q in zip(tree.leaves(refeed), tree.leaves(pf)):
        np.testing.assert_allclose(q[:, 1, :plen].numpy(), r[:, 1, :plen].numpy(), rtol=0, atol=ATOL_F32)
        assert not q[:, 0].any() and not q[:, 2].any()
    np.testing.assert_allclose(last[0].numpy(), lg_r[1, 0].numpy(), rtol=0, atol=ATOL_LOGITS_F32)
    assert int(last[0, :503].argmax()) == int(lg_r[1, 0, :503].argmax())


def test_cache_dims_and_ctx():
    m = build_model(smoke_config("qwen3-1.7b"))
    assert m.cache_dims() == {"body": {"b0": {"k": (None, "batch", "kv_seq", "kv_heads", "head_dim"),
                                               "v": (None, "batch", "kv_seq", "kv_heads", "head_dim")}}}
    x = torch.ones(2)
    assert NO_CTX.cons(x, ("batch",)) is x
    assert make_ctx() is NO_CTX  # one device: nothing to carry until ROADMAP.md queue A3
