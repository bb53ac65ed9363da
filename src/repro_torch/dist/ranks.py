"""Rank executors of the paper's all-to-all encode schedules: one processor a
process, each port group a real exchange of messages between ranks.

The counterpart of the reference's mesh executors
(``repro.dist.collectives.ir_encode_jit`` and its dispatches). There, one
program runs across the mesh and device ``k`` holds packet ``x_k`` as a
``(1, *payload)`` block; here every rank of a :class:`RankMesh
<repro_torch.launch.mesh.RankMesh>` runs processor ``k``'s program on its
own block, with only row ``k`` of every ``(K, …)`` coefficient constant (and
of its Shoup dual) baked on its device — the reference's sharding of those
constants on dim 0. Plans, IRs, lowerings, budgets and the overlap and
tracing machinery are the one-card executor's
(:mod:`repro_torch.dist.collectives`); only the communication differs.

Every port group of every round is ONE ``torch.distributed.batch_isend_irecv``
on each rank that takes part: a rank that is a source in the group sends its
stacked source slots to its destination, a destination receives from its
source, a self-pair is copied locally with no send, and a rank that is
neither does nothing. The semantics are the reference's: a ``store`` group
must cover every rank, an ``add`` group may be partial (non-receivers add
nothing), a slot never written reads as zero, every send of a round reads the
pre-round state, and receive coefficients are Shoup-multiplied after the
receive.

Transport (:func:`gloo_exchange`): the group's backend must be gloo. On a
CUDA device the payload is copied into a pinned host buffer and sent from
there, and a message is received into a pinned host buffer and copied to the
card: gloo's point-to-point calls read the tensor's memory from the host, and a
CUDA tensor handed to them aborts the sending process (torch 2.11, on an
H100). Residues travel as their
``int32`` bit patterns. No other backend is taken, and none is chosen for the
caller: NCCL, which needs one card a rank, waits for a machine with two or
more cards (ROADMAP A2).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from ..core.field import M31, NTT, madd, shoup_mul, shoup_precompute, to_tensor
from ..core.ir import ScheduleIR
from ..core.schedule import plan_butterfly, plan_prepare_shoot
from ..topo.hierarchical import plan_hierarchical, plan_multilevel
from .collectives import (
    _apply_local,
    _apply_pipeline,
    _bcast,
    _check_budget,
    _compile_ops,
    _execute,
    _resolve_kernels,
    _stepper,
    _traced_runner,
    _wait,
    expected_hier_permute_count,
    expected_multilevel_permute_count,
    expected_permute_count,
)

__all__ = [
    "gloo_exchange",
    "ir_encode_ranks",
    "ps_encode_ranks",
    "allgather_encode_ranks",
    "butterfly_ranks",
    "hierarchical_encode_ranks",
    "multilevel_encode_ranks",
]


# ``all_gather_into_tensor``, named ``all_gather_single`` from torch 2.13 on
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _check_backend(group):
    backend = dist.get_backend(group)
    if backend != "gloo":
        raise ValueError(
            f"the rank executors exchange messages over gloo; this group's backend is {backend!r}. "
            "NCCL, one card a rank, waits for a machine with two or more cards (ROADMAP A2)"
        )


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` in host memory, for gloo: a CPU tensor as it is, a CUDA one
    copied into a pinned buffer (the copy waits for the stream's work)."""
    if not t.is_cuda:
        return t.contiguous()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host


def gloo_exchange(payload, send_to, recv_from, shape, *, group, tag: int, device, dtype=torch.int32):
    """One port group on this rank, over gloo: send ``payload`` to the global
    rank ``send_to`` and receive a ``shape`` tensor of ``dtype`` (residues'
    ``int32`` bit patterns by default) from ``recv_from`` in ONE
    ``batch_isend_irecv`` (either may be ``None``; when both are this rank's
    own, the pair is a local copy and nothing is sent). Returns the received
    tensor on ``device`` (``None`` when nothing was received). On a CUDA
    device both ends are staged through pinned host memory."""
    me = dist.get_rank()
    if send_to is not None and send_to == me:
        return payload  # a self-pair: a fresh stack of this rank's own slots
    ops = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, _to_host(payload), send_to, group, tag))
    inbox = None
    if recv_from is not None:
        inbox = torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")
        ops.append(dist.P2POp(dist.irecv, inbox, recv_from, group, tag))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if inbox is None:
        return None
    return inbox.to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# THE rank executor: any ScheduleIR whose rounds are permutations
# ---------------------------------------------------------------------------


def ir_encode_ranks(
    mesh,
    axes,
    ir: ScheduleIR,
    *,
    q: int = M31,
    kernels: str | None = None,
    tracer=None,
    topo=None,
    metrics=None,
):
    """Rank executor of any :class:`ScheduleIR`: the rank at processor index
    ``k`` over ``axes`` (:meth:`RankMesh.index`, the reference's ``P(axes)``
    order) runs processor ``k``'s program on its own ``(1, *payload)`` block.
    Every rank of the mesh calls it and the returned callable, with blocks
    of one shape; ranks that differ on the other axes run independent
    encodes side by side.

    ``kernels`` lowers the LocalOps as the one-card
    :func:`~repro_torch.dist.collectives.ir_encode` does, on this rank's
    block: in ``"cuda"`` mode one general row goes to ``butterfly_mac`` with
    parts ``(n_in, 1, P)``, several to ``gf_matmul`` ``(n_gen, n_in)·(n_in,
    P)``; ``None`` picks ``"cuda"`` on a CUDA device and ``"fused"`` on the
    CPU. An ``overlap=True`` LocalOp runs on a second CUDA stream beside the
    following round's transfer.

    ``tracer`` opts into one span per CommRound (and per other LocalOp) on
    every rank, with the one-card executor's names and attributes, each
    bracketed by ``torch.cuda.synchronize`` and a barrier of the mesh's group,
    so a round span lasts until every rank has finished the round. Each rank
    records into its own tracer and ``metrics`` registry; calibration
    (``repro_torch.obs.feed``) is fed from rank 0's spans.

    The callable carries ``ir``, ``permute_count`` (port groups per call),
    ``permutes_run`` (port groups the last call ran, on this rank as on
    every other), ``kernels``, ``device`` and ``transport`` (the name of the
    function that moves a port group's messages).
    """
    axes = _axes(axes)
    K = mesh.size(axes)
    if K != ir.K:
        raise ValueError(f"mesh axes {axes!r} give {K} ranks, IR has {ir.K}")
    group = mesh.group
    _check_backend(group)
    dev = mesh.device
    kernels = _resolve_kernels(kernels, dev)
    k = mesh.index(axes)
    peers = [mesh.peer(axes, j) for j in range(K)]

    def bake(arr):  # this rank's row of a (K, ...) constant, and its Shoup dual
        arr = np.ascontiguousarray(np.asarray(arr).astype(np.uint32)[k : k + 1])
        return to_tensor(arr, dev), to_tensor(shoup_precompute(arr, q), dev)

    def route(g):
        """(send_to, recv_from): the global ranks this rank sends to and
        receives from in the group (``None``: it does not)."""
        send_to = next((peers[d] for s, d in g.pairs if s == k), None)
        recv_from = next((peers[s] for s, d in g.pairs if d == k), None)
        return send_to, recv_from

    ops = _compile_ops(ir, bake, kernels, route, "device")

    def apply_comm(groups, buf, zero, npay):
        updates = []
        for g in groups:
            send_to, recv_from = g.route
            payload = None
            if send_to is not None:
                payload = torch.stack([buf.get(s, zero) for s in g.src_slots], dim=1)
            shape = (1, len(g.src_slots), *zero.shape[1:])
            recv = gloo_exchange(payload, send_to, recv_from, shape, group=group,
                                 tag=run.permutes_run, device=dev)
            run.permutes_run += 1
            if recv is None:  # a non-receiver of an add group adds nothing
                continue
            if g.coef is not None:
                recv = shoup_mul(recv, _bcast(g.coef[0], npay), _bcast(g.coef[1], npay), q)
            for i, ds in enumerate(g.dst_slots):
                updates.append((ds, recv[:, i], g.mode))
        for ds, v, mode in updates:  # sends all read pre-round state
            buf[ds] = v if mode == "store" else (madd(buf[ds], v, q) if ds in buf else v)
        return buf

    apply_local = functools.partial(_apply_local, kernels=kernels, q=q)
    apply_op, join = _stepper(ops, dev, apply_comm, apply_local)

    def wait():
        _wait(dev)
        dist.barrier(group)

    traced = None
    if tracer is not None:
        traced = _traced_runner(ir, ops, apply_op, join, tracer, topo, metrics, wait=wait)

    def run(x):
        x = to_tensor(x, dev)
        if x.ndim < 1 or x.shape[0] != 1:
            raise ValueError(f"x must be this rank's block, shape (1, *payload), got {tuple(x.shape)}")
        run.permutes_run = 0
        zero = torch.zeros_like(x)
        npay = x.ndim - 1
        if traced is not None:
            return traced(x, zero, npay)
        return _execute(ops, apply_op, join, ir.out_slot, x, zero, npay)

    run.ir = ir
    run.permute_count = sum(len(op[1]) for op in ops if op[0] == "comm")
    run.permutes_run = 0
    run.kernels = kernels
    run.device = dev
    run.transport = gloo_exchange.__name__
    return run


# ---------------------------------------------------------------------------
# the dispatches: plan, IR, budget, executor — as on one card
# ---------------------------------------------------------------------------


def _matrix_for(mesh, axes, A) -> np.ndarray:
    K = mesh.size(axes)
    A = np.asarray(A)
    if A.shape != (K, K):
        raise ValueError(f"A must be ({K}, {K}) to match mesh axes {_axes(axes)!r}, got {A.shape}")
    return A


def ps_encode_ranks(mesh, axis: str, A, *, p: int = 1, q: int = M31, kernels: str | None = None,
                    pipeline: str = ""):
    """The universal encode ``out = x @ A`` over GF(q) on the ranks of
    ``axis``, K = its size: the counterpart of ``ps_encode_jit``. Returns
    ``(fn, plan)``; ``fn`` maps this rank's ``(1, *payload)`` block to its
    encoded block."""
    A = _matrix_for(mesh, axis, A)
    plan = plan_prepare_shoot(A.shape[0], p)
    ir = _apply_pipeline(plan.to_ir(A, q=q), pipeline)
    _check_budget(ir, expected_permute_count(plan))
    return ir_encode_ranks(mesh, axis, ir, q=q, kernels=kernels), plan


def hierarchical_encode_ranks(mesh, inter_axis: str, intra_axis: str, A, *, p: int = 1, q: int = M31,
                              kernels: str | None = None, pipeline: str = ""):
    """The two-level encode on the ranks of ``inter_axis`` × ``intra_axis``:
    rank (g, i) holds packet k = g·I + i. The counterpart of
    ``hierarchical_encode_jit``; returns ``(fn, plan)``."""
    axes = (inter_axis, intra_axis)
    A = _matrix_for(mesh, axes, A)
    plan = plan_hierarchical(A.shape[0], p, k_intra=mesh.axis_size(intra_axis))
    ir = _apply_pipeline(plan.to_ir(A, q=q), pipeline)
    _check_budget(ir, expected_hier_permute_count(plan))
    return ir_encode_ranks(mesh, axes, ir, q=q, kernels=kernels), plan


def multilevel_encode_ranks(mesh, axes, A, *, p: int = 1, q: int = M31, kernels: str | None = None,
                            pipeline: str = ""):
    """The recursive N-level encode on the ranks of ``axes``, outermost →
    innermost (the last varies fastest). The counterpart of
    ``multilevel_encode_jit``; returns ``(fn, plan)``."""
    axes = _axes(axes)
    A = _matrix_for(mesh, axes, A)
    levels = tuple(mesh.axis_size(a) for a in reversed(axes))  # innermost first
    plan = plan_multilevel(A.shape[0], p, levels)
    ir = _apply_pipeline(plan.to_ir(A, q=q), pipeline)
    _check_budget(ir, expected_multilevel_permute_count(plan))
    return ir_encode_ranks(mesh, axes, ir, q=q, kernels=kernels), plan


def butterfly_ranks(mesh, axis: str, *, p: int = 1, q: int = NTT, inverse: bool = False,
                    kernels: str | None = None, pipeline: str = ""):
    """The radix-(p+1) DFT butterfly on the ranks of ``axis``: forward
    computes ``x @ butterfly_target_matrix``, inverse undoes it exactly. The
    counterpart of ``butterfly_jit``; returns ``(fn, plan)``."""
    plan = plan_butterfly(mesh.size(axis), p, q)
    ir = _apply_pipeline(plan.to_ir(inverse=inverse), pipeline)
    _check_budget(ir, plan.H * p)
    return ir_encode_ranks(mesh, axis, ir, q=q, kernels=kernels), plan


def allgather_encode_ranks(mesh, axis: str, A, *, q: int = M31):
    """Baseline encode on the ranks of ``axis``: ONE
    ``all_gather_into_tensor`` gives every rank every packet, then rank k
    contracts them with its own column of A — the counterpart of
    ``allgather_encode_jit``, kept as the foil of the IR path (deliberately
    not routed through it). On a CUDA device the gather is staged through
    pinned host memory, as :func:`gloo_exchange` stages a port group."""
    A = _matrix_for(mesh, axis, A)
    K = A.shape[0]
    group = mesh.axis_group(axis)
    _check_backend(group)
    dev = mesh.device
    k = mesh.index(axis)
    # the gather lands in the group's rank order; row j of the packets is
    # processor j's, which sits at group rank ``order[j]``
    members = sorted(mesh.peer(axis, j) for j in range(K))
    order = torch.as_tensor([members.index(mesh.peer(axis, j)) for j in range(K)], device=dev)
    col = np.ascontiguousarray(A[:, k]).astype(np.uint32)  # processor k needs column A[:, k]
    c, c_sh = to_tensor(col, dev), to_tensor(shoup_precompute(col, q), dev)

    def run(x):
        x = to_tensor(x, dev)
        if x.ndim < 1 or x.shape[0] != 1:
            raise ValueError(f"x must be this rank's block, shape (1, *payload), got {tuple(x.shape)}")
        gathered = torch.empty((K, *x.shape[1:]), dtype=torch.int32, pin_memory=dev.type == "cuda")
        _all_gather(gathered, _to_host(x), group=group)
        xs = gathered.to(dev, non_blocking=True).index_select(0, order)
        npay = x.ndim - 1
        acc = None
        for j in range(K):
            term = shoup_mul(xs[j][None], _bcast(c[j : j + 1], npay), _bcast(c_sh[j : j + 1], npay), q)
            acc = term if acc is None else madd(acc, term, q)
        return acc

    run.device = dev
    run.transport = "all_gather_into_tensor"
    return run
