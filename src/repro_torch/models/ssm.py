"""Attention-free sequence mixers: Mamba (selective SSM, Jamba's mixer) and
RWKV-6 "Finch" (data-dependent decay WKV), with O(1)-state decode steps.

A port of the reference package's ``models/ssm.py``. The reference scans
time with ``jax.lax.scan``; here each scan is a Python loop over the S
steps (:func:`_scan`), with the per-step discretisation (``dA_t``, ``dBu_t``) and the WKV
outer product ``k_t v_tᵀ`` made inside the loop: materialising them for the
whole sequence would cost about 2 × 69 GB a layer at Jamba's width.
``cfg.time_chunk > 0`` runs the steps in checkpointed chunks when autograd
records (the reference's ``jax.checkpoint``): the backward pass keeps only
the state at each chunk's start and runs the chunk again. The values are
the unchunked loop's.

The decode state of a Mamba layer is the tuple ``(h (B, d_in, N) float32,
conv_tail (B, d_conv - 1, d_in))``; of an RWKV layer the dict ``{"wkv"
(B, H, hd, hd) float32, "tm_prev" (B, 1, d), "cm_prev" (B, 1, d)}``. The
decode forms write the new state into the tensors they are given, in place
(they are views of the stacked cache), and return them.

Leaf names and layouts are the reference's, so
``convert.params_from_reference`` carries weights across as they are. The
leaves made without a draw (``dt_proj_b``, ``A_log``, ``D``, ``conv_b``,
``w0``, ``ln_x``) are built from numpy as the reference builds them, so
they hold the same bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
from torch.utils.checkpoint import checkpoint

from .layers import NO_CTX, init_device, layernorm, rmsnorm, rmsnorm_init, truncnorm_init


def _from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """A leaf the reference builds in numpy, on ``device`` (shape and dtype
    only on the ``meta`` device)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return torch.empty(t.shape, dtype=t.dtype, device="meta") if device.type == "meta" else t.to(device)


def _shift(x, x_prev):
    """The token shift: x moved one step later in time, its first row
    ``x_prev`` (zeros when ``None``)."""
    if x_prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([x_prev.to(x.dtype), x], dim=1)[:, :-1]


def _sampled_steps(n: int) -> int:
    """How many of a scan's ``n`` steps to run: all of them, unless a
    dispatch mode that counts ops (``launch.op_cost.OpCounter``) is active
    and asks, through its ``scan_steps``, for fewer (it is told ``n``)."""
    for mode in _get_current_dispatch_mode_stack():
        steps = getattr(mode, "scan_steps", None)
        if steps is not None:
            mode.scan_lengths.add(n)
            return min(steps, n)
    return n


def _scan(step, carry, n: int):
    """``step(carry, t) → (carry, y_t)`` over ``t`` in ``range(n)`` (the
    reference's ``lax.scan``): returns (the last carry, the y_t stacked on
    axis 1). Under an op counter that asks for ``m < n`` steps, only steps
    0..m-1 run and zeros (no gradient, no op) stand for the rest, whose
    carry stops at step m: the stack costs what all n outputs cost, and the
    count is affine in m, so two such counts extrapolate to n exactly."""
    run = _sampled_steps(n)
    ys = []
    for t in range(run):
        carry, y = step(carry, t)
        ys.append(y)
    if run < n:
        ys += [torch.zeros_like(ys[-1])] * (n - run)
    return carry, torch.stack(ys, dim=1)


def _chunked_scan(run, state, xs: tuple, time_chunk: int):
    """``run(state, *xs)`` over the time axis (1) of every ``xs``, as
    checkpointed chunks of ``time_chunk`` steps when that divides S and
    autograd records. Returns (last state, outputs stacked on axis 1)."""
    S = xs[0].shape[1]
    if not (time_chunk and S > time_chunk and S % time_chunk == 0 and torch.is_grad_enabled()):
        return run(state, *xs)
    ys = []
    for c in range(0, S, time_chunk):
        state, y = checkpoint(run, state, *(a[:, c:c + time_chunk] for a in xs), use_reentrant=False)
        ys.append(y)
    return state, torch.cat(ys, dim=1)


# ---------------------------------------------------------------------------
# Mamba (S6) block — Jamba's mixer [arXiv:2312.00752, 2403.19887]
# ---------------------------------------------------------------------------


def mamba_init(generator, cfg, dtype=torch.bfloat16):
    sc = cfg.ssm
    d = cfg.d_model
    d_in = sc.expand * d
    dev = init_device(generator)
    dt_rank = sc.dt_rank or max(1, math.ceil(d / 16))
    A = np.tile(np.arange(1, sc.d_state + 1, dtype=np.float32), (d_in, 1))
    dt_b = np.log(np.expm1(np.clip(np.random.default_rng(0).uniform(1e-3, 1e-1, d_in), 1e-4, None)))
    return {
        "in_proj": truncnorm_init(generator, (d, 2 * d_in), dtype),
        "conv_w": truncnorm_init(generator, (sc.d_conv, d_in), dtype, scale=0.1),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=dev),
        "x_proj": truncnorm_init(generator, (d_in, dt_rank + 2 * sc.d_state), dtype),
        "dt_proj_w": truncnorm_init(generator, (dt_rank, d_in), dtype),
        "dt_proj_b": _from_numpy(dt_b.astype(np.float32), dev),
        "A_log": _from_numpy(np.log(A), dev),
        "D": torch.ones((d_in,), dtype=torch.float32, device=dev),
        "out_proj": truncnorm_init(generator, (d_in, d), dtype),
        "dt_norm": rmsnorm_init(dt_rank, dtype, dev),
        "b_norm": rmsnorm_init(sc.d_state, dtype, dev),
        "c_norm": rmsnorm_init(sc.d_state, dtype, dev),
    }


def mamba_specs(cfg):
    return {
        "in_proj": ("d_model", "d_ff"),
        "conv_w": (None, "d_ff"),
        "conv_b": ("d_ff",),
        "x_proj": ("d_ff", None),
        "dt_proj_w": (None, "d_ff"),
        "dt_proj_b": ("d_ff",),
        "A_log": ("d_ff", None),
        "D": ("d_ff",),
        "out_proj": ("d_ff", "d_model"),
        "dt_norm": {"scale": (None,)},
        "b_norm": {"scale": (None,)},
        "c_norm": {"scale": (None,)},
    }


def _mamba_scan(u, dt, B, C, A, D, h0=None, time_chunk: int = 0):
    """u, dt: (Bt, S, Din); B, C: (Bt, S, N); A: (Din, N); all float32.
    h_t = exp(dt_t·A)·h_{t-1} + dt_t·B_t·u_t;  y_t = (h_t · C_t) + D·u_t.
    Returns (y (Bt, S, Din), h_S). ``dA_t`` and ``dBu_t`` are made step by
    step, never for the whole sequence."""
    Bt, S, Din = u.shape
    h = torch.zeros((Bt, Din, A.shape[1]), dtype=torch.float32, device=u.device) if h0 is None else h0

    def run(h, u, dt, B, C):
        def step(h, t):
            dA = torch.exp(dt[:, t, :, None] * A)  # (Bt, Din, N)
            dBu = (dt[:, t] * u[:, t])[..., None] * B[:, t, None, :]
            h = dA * h + dBu
            return h, torch.einsum("bdn,bn->bd", h, C[:, t])

        return _scan(step, h, u.shape[1])

    h_last, ys = _chunked_scan(run, h, (u, dt, B, C), time_chunk)
    return ys + D * u, h_last


def mamba_fwd(params, x, cfg, ctx=NO_CTX, h0=None, conv0=None, return_state=False):
    """x: (B, S, d) → (y, (h_last, conv_tail) or ``None``): the whole
    sequence (train), or the steps after the state (``h0``, ``conv0``)."""
    sc = cfg.ssm
    S = x.shape[1]
    u, z = torch.chunk(x @ params["in_proj"], 2, dim=-1)
    # causal depthwise conv1d (kernel d_conv) over the tail before u
    pad = sc.d_conv - 1
    u_p = F.pad(u, (0, 0, pad, 0)) if conv0 is None else torch.cat([conv0.to(u.dtype), u], dim=1)
    w = params["conv_w"]
    conv = u_p[:, :S] * w[0]
    for i in range(1, sc.d_conv):
        conv = conv + u_p[:, i:i + S] * w[i]
    u_c = F.silu(conv + params["conv_b"])
    dt_rank = params["dt_proj_w"].shape[0]
    dt, Bm, Cm = torch.split(u_c @ params["x_proj"], [dt_rank, sc.d_state, sc.d_state], dim=-1)
    dt = rmsnorm(params["dt_norm"], dt)
    Bm = rmsnorm(params["b_norm"], Bm).float()
    Cm = rmsnorm(params["c_norm"], Cm).float()
    dt = F.softplus(dt.float() @ params["dt_proj_w"].float() + params["dt_proj_b"])
    A = -torch.exp(params["A_log"])
    y, h_last = _mamba_scan(u_c.float(), dt, Bm, Cm, A, params["D"], h0, time_chunk=cfg.time_chunk)
    out = (y.to(x.dtype) * F.silu(z)) @ params["out_proj"]
    if return_state:
        return out, (h_last, u_p[:, -pad:] if pad > 0 else None)
    return out, None


def mamba_decode(params, x, cfg, state):
    """One token: x (B, 1, d); ``state`` = (h (B, Din, N) float32,
    conv_tail (B, d_conv - 1, Din)), written in place. Returns (y, state)."""
    h, conv_tail = state
    out, (h2, tail2) = mamba_fwd(params, x, cfg, h0=h, conv0=conv_tail, return_state=True)
    h.copy_(h2)
    conv_tail.copy_(tail2)
    return out, state


def mamba_state_init(cfg, batch, dtype=torch.bfloat16, device=None, layers: int | None = None):
    """Zeros: (h (batch, d_in, d_state) float32, conv_tail (batch, d_conv -
    1, d_in)), with a leading ``layers`` axis when it is given."""
    sc = cfg.ssm
    d_in = sc.expand * cfg.d_model
    lead = () if layers is None else (layers,)
    return (
        torch.zeros((*lead, batch, d_in, sc.d_state), dtype=torch.float32, device=device),
        torch.zeros((*lead, batch, sc.d_conv - 1, d_in), dtype=dtype, device=device),
    )


def mamba_state_dims():
    return (("batch", "d_ff", "state"), ("batch", "conv", "d_ff"))


# ---------------------------------------------------------------------------
# RWKV-6 "Finch" — data-dependent decay WKV [arXiv:2404.05892]
# ---------------------------------------------------------------------------

_LORA_R = 32  # the token-shift ddlerp's rank, a target
_LORA_W = 64  # the decay's rank


def rwkv6_init(generator, cfg, dtype=torch.bfloat16):
    d = cfg.d_model
    H = cfg.n_heads
    dev = init_device(generator)
    return {
        # token-shift ddlerp: 5 targets (r, k, v, w, g)
        "mu": truncnorm_init(generator, (5, d), dtype, scale=0.5),
        "lora_A": truncnorm_init(generator, (d, 5 * _LORA_R), dtype),
        "lora_B": truncnorm_init(generator, (5, _LORA_R, d), dtype, scale=0.01),
        "wr": truncnorm_init(generator, (d, d), dtype),
        "wk": truncnorm_init(generator, (d, d), dtype),
        "wv": truncnorm_init(generator, (d, d), dtype),
        "wg": truncnorm_init(generator, (d, d), dtype),
        "wo": truncnorm_init(generator, (d, d), dtype),
        # decay: w_t = exp(-exp(w0 + lora_w(x)))
        "w0": _from_numpy(np.linspace(-6.0, -0.5, d, dtype=np.float32), dev),
        "w_lora_A": truncnorm_init(generator, (d, _LORA_W), dtype),
        "w_lora_B": truncnorm_init(generator, (_LORA_W, d), dtype, scale=0.01),
        "u": truncnorm_init(generator, (H, d // H), torch.float32, scale=0.3),  # bonus
        "ln_x": {"scale": torch.ones((d,), dtype=dtype, device=dev),
                 "bias": torch.zeros((d,), dtype=dtype, device=dev)},
    }


def rwkv6_specs(cfg):
    return {
        "mu": (None, "d_model"),
        "lora_A": ("d_model", None),
        "lora_B": (None, None, "d_model"),
        "wr": ("d_model", "heads"),
        "wk": ("d_model", "heads"),
        "wv": ("d_model", "heads"),
        "wg": ("d_model", "heads"),
        "wo": ("heads", "d_model"),
        "w0": ("d_model",),
        "w_lora_A": ("d_model", None),
        "w_lora_B": (None, "d_model"),
        "u": ("heads", None),
        "ln_x": {"scale": ("d_model",), "bias": ("d_model",)},
    }


def _wkv6_scan(r, k, v, w, u, S0=None, time_chunk: int = 0):
    """r, k, v: (B, S, H, hd); w: (B, S, H, hd) decay in (0, 1); u: (H, hd)
    bonus. State (B, H, hd, hd) float32, per head:
    y_t = (S_{t-1} + u ⊙ k_t v_tᵀ)ᵀ r_t;  S_t = diag(w_t) S_{t-1} + k_t v_tᵀ.
    Returns (y (B, S, H, hd) float32, S_S). The outer product is made step
    by step."""
    B, S, H, hd = r.shape
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device) if S0 is None else S0

    def run(state, r, k, v, w):
        def step(state, t):
            kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B, H, hd, hd)
            y = torch.einsum("bhij,bhi->bhj", state + u[None, :, :, None] * kv, r[:, t])
            return w[:, t, :, :, None] * state + kv, y

        return _scan(step, state, r.shape[1])

    S_last, ys = _chunked_scan(run, state, tuple(a.float() for a in (r, k, v, w)), time_chunk)
    return ys, S_last


def rwkv6_time_mix(params, x, cfg, ctx=NO_CTX, state=None, x_prev=None, return_state=False):
    """x: (B, S, d); ``state``: (B, H, hd, hd) float32; ``x_prev``: (B, 1, d),
    the token-shift tail. Returns (y, (S_last, x's last row) or ``None``)."""
    B, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    dx = _shift(x, x_prev) - x
    # data-dependent lerp (ddlerp) a target
    lora = torch.tanh(x @ params["lora_A"]).reshape(B, S, 5, -1)
    xr, xk, xv, xw, xg = (x + dx * (params["mu"][i] + lora[:, :, i] @ params["lora_B"][i]) for i in range(5))
    r = (xr @ params["wr"]).reshape(B, S, H, hd)
    k = (xk @ params["wk"]).reshape(B, S, H, hd)
    v = (xv @ params["wv"]).reshape(B, S, H, hd)
    g = F.silu(xg @ params["wg"])
    wdec = params["w0"] + torch.tanh(xw @ params["w_lora_A"]).float() @ params["w_lora_B"].float()
    w = torch.exp(-torch.exp(wdec)).reshape(B, S, H, hd)
    y, S_last = _wkv6_scan(r, k, v, w, params["u"], state, time_chunk=cfg.time_chunk)
    y = layernorm(params["ln_x"], y.reshape(B, S, d).to(x.dtype)) * g
    out = y @ params["wo"]
    if return_state:
        return out, (S_last, x[:, -1:, :])
    return out, None


def rwkv6_channel_mix_init(generator, cfg, dtype=torch.bfloat16):
    d = cfg.d_model
    return {
        "mu_k": truncnorm_init(generator, (d,), dtype, scale=0.5),
        "wk": truncnorm_init(generator, (d, cfg.d_ff), dtype),
        "wv": truncnorm_init(generator, (cfg.d_ff, d), dtype),
    }


def rwkv6_channel_mix_specs():
    return {"mu_k": ("d_model",), "wk": ("d_model", "d_ff"), "wv": ("d_ff", "d_model")}


def rwkv6_channel_mix(params, x, x_prev=None, return_state=False):
    """x: (B, S, d); ``x_prev``: (B, 1, d). Returns (y, x's last row or
    ``None``)."""
    xk = x + (_shift(x, x_prev) - x) * params["mu_k"]
    out = torch.square(F.relu(xk @ params["wk"])) @ params["wv"]
    if return_state:
        return out, x[:, -1:, :]
    return out, None


def rwkv6_state_init(cfg, batch, dtype=torch.bfloat16, device=None, layers: int | None = None):
    """Zeros: {"wkv": (batch, H, hd, hd) float32, "tm_prev", "cm_prev":
    (batch, 1, d)}, with a leading ``layers`` axis when it is given."""
    d = cfg.d_model
    H = cfg.n_heads
    lead = () if layers is None else (layers,)
    return {
        "wkv": torch.zeros((*lead, batch, H, d // H, d // H), dtype=torch.float32, device=device),
        "tm_prev": torch.zeros((*lead, batch, 1, d), dtype=dtype, device=device),
        "cm_prev": torch.zeros((*lead, batch, 1, d), dtype=dtype, device=device),
    }


def rwkv6_state_dims():
    return {
        "wkv": ("batch", "heads", None, None),
        "tm_prev": ("batch", None, "d_model"),
        "cm_prev": ("batch", None, "d_model"),
    }
