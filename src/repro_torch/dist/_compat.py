"""``shard_map`` over a mesh of ranks: the counterpart of the reference's
``dist/_compat.py``.

There, ``shard_map`` runs a function on each device's block of its inputs
(the escape hatch from GSPMD's sharding propagation). Here it is built on
DTensor's ``local_map``: each input is placed by its spec (a plain tensor is
the full tensor every rank holds: each rank keeps its block, nothing is
sent), the function runs on every rank's local blocks, and its outputs are
DTensors with the placements of their specs. Specs are lowered to placements
by :func:`repro_torch.dist.sharding.placements_for`, as ``named_sharding``
lowers them. Inside the function a collective over a mesh axis is a
``torch.distributed`` call on ``mesh.axis_group(axis)`` (the reference's
``psum``, ``ppermute``): :func:`all_reduce` is ``psum``/``pmax``.

Specs follow the reference's: one a positional argument, applied to every
tensor leaf of it (a pytree of dicts, lists and tuples), and one an output.
The function returns a tensor (``out_specs`` one spec) or a tuple or list
of tensors (``out_specs`` a tuple of specs, one each). When no input is a
DTensor the outputs are given back as full plain tensors, so a caller that
holds full tensors gets full tensors.

A block's gradient leaves with the block's placements: every rank's
gradient of a replicated input is taken to be the whole one, which holds
where the ranks along that axis all do the same work. A region whose ranks
do different parts of the work along some axes (their batch rows, their
channels, their heads) names them in ``work_axes``: the gradient of an input
replicated over one of them is a pending sum over it, which DTensor
completes (the reference's ``shard_map`` transposes a replicated input the
same way).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from .sharding import NamedSharding, placements_for

__all__ = ["shard_map", "all_reduce"]


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``t`` reduced over ``group``'s ranks (``psum``, or
    ``pmax`` with ``op=MAX``), on ``t``'s device (the group's backend takes
    it there: gloo, or the port's staging backend on a card)."""
    out = t.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _is_spec(s) -> bool:
    return isinstance(s, tuple) and all(e is None or isinstance(e, str) or (
        isinstance(e, tuple) and all(isinstance(a, str) for a in e)) for e in s)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient leaves contiguous: a block's gradient
    goes back into DTensor's views, which need contiguous blocks."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _on_blocks(f):
    def run(*args):
        args = pytree.tree_map(lambda t: _ContiguousGrad.apply(t) if isinstance(t, torch.Tensor) and t.requires_grad
                               else t, args)
        return f(*args)

    return run


def shard_map(f, mesh, in_specs, out_specs, *, work_axes=()):
    """``f`` mapped over ``mesh``'s ranks: ``in_specs`` one spec a positional
    argument, ``out_specs`` one spec (a single output) or a tuple of specs
    (one an output of a tuple). On a mesh of one rank ``f`` runs on the
    tensors as they are. An input's gradient is a pending sum over each axis
    of ``work_axes`` it is replicated on."""
    single = _is_spec(out_specs)
    # local_map reads a tuple as one placement list an output: one output's is a list
    out_pl = list(placements_for(mesh, out_specs)) if single else tuple(list(placements_for(mesh, s))
                                                                        for s in out_specs)

    def mapped(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments, {len(in_specs)} in_specs")
        if mesh.device_mesh is None or mesh.device_mesh.size() == 1:
            return f(*args)
        any_dtensor = False
        placed, in_pl, grad_pl = [], [], []
        for arg, spec in zip(args, in_specs):
            leaves, treedef = pytree.tree_flatten(arg)
            pl = placements_for(mesh, spec)
            gpl = tuple(Partial() if ax in work_axes and isinstance(p, Replicate) else p
                        for ax, p in zip(mesh.axis_names, pl))
            out = []
            for leaf in leaves:
                if isinstance(leaf, torch.Tensor):
                    any_dtensor |= isinstance(leaf, DTensor)
                    out.append(NamedSharding(mesh, tuple(spec)).place(leaf))
                    in_pl.append(pl)
                    grad_pl.append(gpl)
                else:
                    out.append(leaf)
                    in_pl.append(None)
                    grad_pl.append(None)
            placed.append(pytree.tree_unflatten(out, treedef))
        res = local_map(_on_blocks(f), out_placements=out_pl, in_placements=tuple(in_pl),
                        in_grad_placements=tuple(grad_pl), device_mesh=mesh.device_mesh,
                        redistribute_inputs=True)(*placed)
        if any_dtensor:
            return res
        if single:
            return res.full_tensor()
        return type(res)(r.full_tensor() if isinstance(r, DTensor) else r for r in res)

    return mapped
