"""A model's training state as a coded checkpoint holds it: parameters in
their dtype, AdamW's moments m and v beside each, and the step, laid out as
``{"params": ..., "opt": {"m": ..., "v": ..., "step": ...}}``.

The configuration lists every parameter (its path and shape); the values are
drawn on the device from the seed, one call a dtype into one flat buffer that
the leaves are views of. The program receives the state's K rows of limbs as
its own ``shard_state_limbs`` makes them; the reference works the rows out
again from the state's bytes (:mod:`bench.reference.limbs`).
"""

from __future__ import annotations

import math

import torch


def _nest(paths_shapes, buf: torch.Tensor) -> dict:
    tree: dict = {}
    off = 0
    for path, shape in paths_shapes:
        n = math.prod(shape)
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = buf[off:off + n].view(shape)
        off += n
    return tree


def make(config: dict, device: torch.device, generator: torch.Generator):
    spec = config["payload"]
    leaves = [(path, tuple(shape)) for path, shape in spec["params"]]
    n = sum(math.prod(s) for _, s in leaves)
    fill = spec["fill"]
    pdt = getattr(torch, spec["params_dtype"])
    mdt = getattr(torch, spec["moments_dtype"])
    params = (torch.randn(n, generator=generator, device=device) * fill["params_std"]).to(pdt)
    m = (torch.randn(n, generator=generator, device=device) * fill["m_std"]).to(mdt)
    v = (torch.randn(n, generator=generator, device=device) * fill["v_std"]).square_().to(mdt)
    step = torch.randint(1, fill["step_max"], (), generator=generator, device=device,
                         dtype=getattr(torch, spec["step_dtype"]))
    return {"params": _nest(leaves, params),
            "opt": {"m": _nest(leaves, m), "v": _nest(leaves, v), "step": step}}


def width(config: dict) -> int:
    """S, the limbs a row, from the configuration alone."""
    spec = config["payload"]
    item = {k: getattr(torch, spec[k]).itemsize for k in ("params_dtype", "moments_dtype", "step_dtype")}
    total = sum(-(-math.prod(shape) * item["params_dtype"] // 2) for _, shape in spec["params"])
    total += 2 * sum(-(-math.prod(shape) * item["moments_dtype"] // 2) for _, shape in spec["params"])
    total += -(-item["step_dtype"] // 2)
    K = config["code"]["K"]
    return -(-total // K)


def to_program(raw, config: dict, device: torch.device) -> torch.Tensor:
    from repro_torch.coded.rs_checkpoint import shard_state_limbs

    limbs, _ = shard_state_limbs(raw, config["code"]["K"], device)
    return limbs


def to_reference(raw, config: dict) -> torch.Tensor:
    from bench.reference.limbs import state_limbs

    return state_limbs(raw, config["code"]["K"])
