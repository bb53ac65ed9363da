"""Checkpoint save/restore in the reference's format.

Format ("logical-full-v1"): one ``state_{step:08d}.npz`` holding every leaf
under its path name (dict keys and sequence indices joined by ``/``, in
JAX's pytree order, see ``repro_torch.tree``) + ``manifest.json`` with the
keys, shapes, dtypes, tree structure and step. Arrays are saved logically
complete. The two packages read each other's checkpoints.

numpy has no bfloat16, so a ``bfloat16`` leaf is written as its raw two
bytes, a ``|V2`` void array, with manifest dtype ``"bfloat16"`` — the form
the reference's own file takes, which the reference reads back by view. A
restore reads a ``|V2`` (or a 16-bit integer) array into a bfloat16 leaf
bit for bit through ``Tensor.view(torch.bfloat16)``.

A state on a mesh of ranks (DTensor leaves) is saved whole: every rank
gathers each leaf's full tensor and rank 0 alone writes the file, whose
arrays are those a one-process save of the same values writes. A restore
with ``shardings=`` (one ``dist.sharding.NamedSharding`` a leaf, as
``train.train_loop.param_shardings`` builds them) places each leaf under
its sharding, possibly on another mesh than the one that saved it (the
reference's elastic-scaling path).

The coded fast path (coded/rs_checkpoint.py) complements this: disk
checkpoints every N steps, in-memory Cauchy parity every n << N steps.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .. import tree
from ..core.field import resolve_device


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(the array written to the file, its manifest dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_torch(arr: np.ndarray, want: torch.dtype) -> torch.Tensor:
    if want == torch.bfloat16:
        if arr.dtype.kind == "V" or arr.dtype in (np.dtype(np.uint16), np.dtype(np.int16)):
            if arr.dtype.itemsize != 2:
                raise ValueError(f"a bfloat16 leaf cannot be read from {arr.dtype}")
            return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(np.array(arr)).to(want)  # a value conversion
    np_want = torch.empty(0, dtype=want).numpy().dtype
    if arr.dtype.kind == "V":
        arr = arr.view(np_want)
    if arr.dtype != np_want:
        arr = arr.astype(np_want)
    return torch.from_numpy(np.array(arr))


def save_checkpoint(path: str, state: Any, step: int, extra: dict | None = None):
    """Write ``state`` at ``step``. With DTensor leaves this is a collective
    call: every rank gathers the full tensors, rank 0 writes, and every rank
    returns the manifest after the file is written."""
    named = tree.flatten_with_names(state)
    meshed = any(isinstance(v, DTensor) for v in named.values())
    named = {k: v.full_tensor() if isinstance(v, DTensor) else v for k, v in named.items()}
    arrays, dtypes = {}, {}
    for k, v in named.items():
        arrays[k], dtypes[k] = _to_numpy(v)
    writer = not meshed or dist.get_rank() == 0
    if writer:
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, f"state_{step:08d}.npz"), **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays),
        "shapes": {k: list(a.shape) for k, a in arrays.items()},
        "dtypes": dtypes,
        "treedef": str(tree.structure(state)),
        "format": "logical-full-v1",
        "shard_id": 0,
        "n_shards": 1,
        "extra": extra or {},
    }
    if writer:
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
    if meshed:
        dist.barrier()
    return manifest


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [
        int(f[len("state_") : -len(".npz")])
        for f in os.listdir(path)
        if f.startswith("state_") and f.endswith(".npz")
    ]
    return max(steps) if steps else None


def restore_checkpoint(path: str, like: Any, step: int | None = None, device=None, shardings=None):
    """Restore into the structure and dtypes of ``like`` (a pytree of
    tensors; tensors on the ``meta`` device do, only shape and dtype are
    read), on ``device`` (``None``: the card). ``shardings``: a matching
    pytree of ``NamedSharding``s; each leaf is then placed under its own on
    its mesh's ranks (every rank reads the file and keeps its block).
    Returns ``(state, step)``."""
    dev = resolve_device(device) if shardings is None else None
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    leaves, treedef = tree.flatten(like)
    names = list(tree.flatten_with_names(like))
    places = [None] * len(leaves) if shardings is None else tree.leaves(shardings)
    if len(places) != len(leaves):
        raise ValueError(f"{len(places)} shardings for {len(leaves)} leaves")
    out = []
    with np.load(os.path.join(path, f"state_{step:08d}.npz")) as data:
        for name, leaf, sh in zip(names, leaves, places):
            t = _to_torch(data[name], leaf.dtype)
            out.append(t.to(dev) if sh is None else sh.place(t))
    return tree.unflatten(treedef, out), step
