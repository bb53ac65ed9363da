"""AdamW, written out element by element in float32 as the reference writes
it (not ``torch.optim.AdamW``, which orders its bias correction and decay
differently and decays every leaf), with:

* fp32 or bf16 moments (``moment_dtype``),
* global-norm gradient clipping,
* linear-warmup + cosine-decay schedule,
* decoupled weight decay on every leaf with ``ndim >= 2`` — the stacked
  norm scales ``(n_layers, d)`` included, as in the reference.

State is a pytree mirroring params: ``{"m": ..., "v": ..., "step": ()}``
with ``step`` an ``int32`` scalar tensor. Leaves are read and written in the
reference's pytree order (``repro_torch.tree``).

On a mesh the leaves are DTensors: each gradient is first laid out as its
parameter (a pending partial sum is reduced), the global norm is the norm of
the whole gradient (each leaf's sum of squares is a partial sum over the
mesh, reduced before the square root), and the new parameter and moments
keep the parameter's placements.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor

from .. import tree


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"  # "float32" | "bfloat16"


def _moment_dtype(cfg: OptConfig) -> torch.dtype:
    return torch.float32 if cfg.moment_dtype == "float32" else torch.bfloat16


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), float32."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_state(cfg: OptConfig, params):
    """Zero moments beside each parameter, on its device (on its placements
    for a DTensor), and step 0."""
    mdt = _moment_dtype(cfg)
    # a DTensor parameter's moments are DTensors on its placements (each rank its block)
    zeros = lambda p: torch.zeros_like(p, dtype=mdt, memory_format=torch.contiguous_format)  # noqa: E731
    step_dev = tree.leaves(params)[0].device
    return {
        "m": tree.map(zeros, params),
        "v": tree.map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=step_dev),
    }


def state_specs(cfg: OptConfig, param_shapes):
    """``init_state``'s pytree as ``meta`` tensors (no storage)."""
    mdt = _moment_dtype(cfg)
    sd = lambda p: torch.empty(p.shape, dtype=mdt, device="meta")
    return {
        "m": tree.map(sd, param_shapes),
        "v": tree.map(sd, param_shapes),
        "step": torch.empty((), dtype=torch.int32, device="meta"),
    }


def global_norm(grads) -> torch.Tensor:
    """sqrt of the float32 sum of squares, summed leaf by leaf in order."""
    total = 0.0
    for g in tree.leaves(grads):
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


def _like(t, p: DTensor):
    """``t`` laid out as the DTensor ``p``."""
    return t if tuple(t.placements) == tuple(p.placements) else t.redistribute(p.device_mesh, p.placements)


def apply_updates(cfg: OptConfig, params, grads, state):
    """One AdamW step. Returns ``(new_params, new_state, metrics)``; the
    inputs are left as they are."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    mdt = _moment_dtype(cfg)

    def upd(p, g, m, v):
        if isinstance(p, DTensor):
            return tuple(_like(t, p) for t in adamw(p, _like(g, p), _like(m, p), _like(v, p)))
        return adamw(p, g, m, v)

    def adamw(p, g, m, v):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g)
        mhat = m32 / b1c
        vhat = v32 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay and p.ndim >= 2:  # no decay on 1-D norms/biases
            delta = delta + cfg.weight_decay * p.float()
        new_p = p.float() - lr * delta
        return new_p.to(p.dtype), m32.to(mdt), v32.to(mdt)

    flat_p, treedef = tree.flatten(params)
    others = []
    for what, t in (("grads", grads), ("m", state["m"]), ("v", state["v"])):
        leaves, td = tree.flatten(t)
        if td != treedef:
            raise ValueError(f"{what} {td} is not the parameters' {treedef}")
        others.append(leaves)
    out = [upd(*leaves) for leaves in zip(flat_p, *others)]
    new_params = tree.unflatten(treedef, [o[0] for o in out])
    new_m = tree.unflatten(treedef, [o[1] for o in out])
    new_v = tree.unflatten(treedef, [o[2] for o in out])
    return new_params, {"m": new_m, "v": new_v, "step": step}, {"grad_norm": gnorm, "lr": lr}
