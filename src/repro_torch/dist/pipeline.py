"""GPipe-style pipeline parallelism over a mesh axis of ranks: the
counterpart of the reference's ``dist/pipeline.py``.

``stack_stage_params`` stacks the S per-stage parameter pytrees on a new
leading axis; sharding that axis over the pipeline axis gives every rank its
own stage's weights. ``pipeline_apply`` runs the classic synchronous GPipe
schedule: N microbatches flow through S stages in N + S - 1 ticks, with one
uniform shift by +1 on the pipeline axis moving activations between
neighbours each tick. The shift is one send and one receive on each rank
through :func:`repro_torch.dist.ranks.gloo_exchange` (staged through pinned
host memory on a CUDA device); the last stage's outputs are summed to every
rank of the axis (``_compat.all_reduce``), as the reference's ``psum`` does.
"""

from __future__ import annotations

import torch

from .. import tree
from ._compat import all_reduce, shard_map
from .ranks import gloo_exchange

__all__ = ["stack_stage_params", "pipeline_apply"]

_TAG = 7001  # the pipeline's point-to-point tag


def stack_stage_params(stage_params: list):
    """[params_0, .., params_{S-1}] → one pytree with a leading stage axis."""
    leaves = [tree.leaves(p) for p in stage_params]
    treedef = tree.flatten(stage_params[0])[1]
    return tree.unflatten(treedef, [torch.stack(ls, dim=0) for ls in zip(*leaves)])


def pipeline_apply(stage_fn, stacked_params, x, *, mesh, axis: str):
    """Apply S = ``mesh.axis_size(axis)`` stages in sequence to every
    microbatch.

    ``stage_fn(params, mb)`` is one stage; ``stacked_params`` has leading dim
    S (see :func:`stack_stage_params`), full on every rank or a DTensor
    sharded on that dim over ``axis``; ``x`` is ``(N, *mb_shape)``, N
    microbatches, the same on every rank of the axis. Returns ``(N,
    *mb_shape)`` with ``out[i] = stage_{S-1}(... stage_0(x[i]))`` on every
    rank (a DTensor replicated over the mesh when an input was one).

    Schedule: tick t ∈ [0, N+S-1): the rank at d on ``axis`` applies its
    stage to microbatch t - d (when in range), then shifts its activation to
    d + 1. Rank S-1's results are summed over the axis so the output is
    replicated.
    """
    S = mesh.axis_size(axis)
    N = x.shape[0]
    d = mesh.index(axis)
    group = mesh.axis_group(axis)
    send_to, recv_from = mesh.peer(axis, (d + 1) % S), mesh.peer(axis, (d - 1) % S)

    def body(params, xx):
        params = tree.map(lambda a: a[0], params)  # (1, ...) → this stage's params
        state = torch.zeros(xx.shape[1:], dtype=xx.dtype, device=xx.device)
        outs = torch.zeros_like(xx)
        for t in range(N + S - 1):
            # stage 0 ingests microbatch t; the others consume the neighbour's
            # activation (garbage during fill and drain never reaches `outs`)
            inp = xx[t % N] if d == 0 else state
            y = stage_fn(params, inp.to(xx.dtype))
            mb = t - (S - 1)
            if mb >= 0 and d == S - 1:
                outs[mb] = y
            if S > 1:
                state = gloo_exchange(y.contiguous(), send_to, recv_from, tuple(y.shape), group=group, tag=_TAG,
                                      device=xx.device, dtype=y.dtype)
            else:
                state = y
        # replicate the last stage's outputs over the axis
        return all_reduce(outs if d == S - 1 else torch.zeros_like(outs), group) if S > 1 else outs

    return shard_map(body, mesh, in_specs=((axis,), ()), out_specs=())(stacked_params, x)
