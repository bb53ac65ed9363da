"""Single-device executors for the paper's all-to-all encode schedules — ONE
generic :func:`ir_encode` that runs any :class:`~repro_torch.core.ir.ScheduleIR`
on one GPU.

The K processors are dim 0 of a ``(K, *payload)`` tensor: row ``k`` is the
packet processor ``k`` holds, and a slot buffer is a dict ``slot → (K,
*payload)`` tensor. Each :class:`~repro_torch.core.ir.CommRound` decomposes
into its port groups (transfers sharing (port, slots, mode) — a uniform
permutation), and every port group becomes exactly one gather along dim 0
with a precomputed ``src_of_dst`` index (the counterpart of one ``ppermute``
of the reference's mesh executor; rows that receive nothing read zero). Each
:class:`~repro_torch.core.ir.LocalOp` becomes a modular contraction against
baked per-processor coefficient constants that live on the device. The
per-family entry points are dispatches: they build the plan, compile it with
``plan.to_ir()``, optionally rewrite it with a named ``topo.passes``
pipeline, and hand the IR to the generic executor — round structure,
coefficient tables and masks all come from the SAME plans as the host
simulator, so this path and the oracle agree bit for bit by construction.

Communication discipline: the executor runs one permutation per port group
and counts them (``fn.permutes_run`` after a call, ``fn.permute_count``
statically); the committed budgets (:func:`expected_permute_count`,
:func:`expected_hier_permute_count`, :func:`expected_multilevel_permute_count`
and ``H·p`` for the butterfly) are asserted at dispatch time
(``ir_permute_count(ir) ≤ budget``).

:func:`allgather_encode` is the deliberate baseline that DOES gather every
packet to every processor, kept as the cost-model foil.

Tensors are ``int32`` bit patterns of canonical residues (``core.field``).
Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``torch.device("cuda")``, a CPU tensor or numpy array
handed to the returned callable is moved there, and with no card the call
raises.

Paper-notation glossary: ``K`` processors, ``p`` ports per round (each
permutation is one port), ``C1`` rounds, ``C2`` per-port elements; ``I``/``G``
the two-level k_intra × k_inter split of :func:`hierarchical_encode`;
*digit-reduction slots* — the §IV shoot buffer layout (one slot per
(p+1)-ary numeral of the remaining target offset; round t zeroes digit t by
shipping the slots with digit_t = ρ on port ρ). :func:`multilevel_encode`
generalizes to any K = Π K_level hierarchy: one gather over the innermost
level, then one digit-reduction shoot per outer level, innermost first.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.field import (
    M31,
    NTT,
    madd,
    resolve_device,
    shoup_mul,
    shoup_precompute,
    to_tensor,
)
from ..core.ir import (
    INPUT_SLOT,
    CommRound,
    LocalOp,
    ScheduleIR,
    ir_permute_count,
    round_port_groups,
)
from ..core.schedule import (
    PrepareShootPlan,
    digit_reduction_slots,
    plan_butterfly,
    plan_prepare_shoot,
)
from ..obs.metrics import get_registry
from ..topo.calibrate import round_features
from ..topo.hierarchical import (
    hier_shoot_message_size,
    multilevel_message_size,
    plan_hierarchical,
    plan_multilevel,
)
from ..topo.model import FullyConnected, schedule_time
from ..topo.passes import PIPELINES

__all__ = [
    "KERNEL_MODES",
    "ir_encode",
    "ps_encode",
    "allgather_encode",
    "butterfly",
    "hierarchical_encode",
    "multilevel_encode",
    "shoot_round_slots",
    "expected_permute_count",
    "expected_hier_permute_count",
    "expected_multilevel_permute_count",
]


def _bcast(coef, npay: int):
    """Append payload broadcast dims to a coefficient tensor."""
    return coef.reshape(coef.shape + (1,) * npay)


KERNEL_MODES = ("torch", "fused", "cuda")


def _resolve_kernels(kernels: str | None, device: torch.device) -> str:
    """LocalOp lowering mode: ``None`` picks the hand-written CUDA kernels
    when the executor's device is a CUDA device and the row-batched fused
    lowering on the CPU; ``"torch"`` is the per-coefficient loop. ``"cuda"``
    on the CPU raises: the kernels have no CPU form."""
    if kernels is None:
        return "cuda" if device.type == "cuda" else "fused"
    if kernels not in KERNEL_MODES:
        raise ValueError(f"kernels must be one of {KERNEL_MODES} or None, got {kernels!r}")
    if kernels == "cuda" and device.type != "cuda":
        raise ValueError(
            f'kernels="cuda" needs a CUDA device, the executor was given {device}'
        )
    return kernels


def _lower_local(step: LocalOp, bake, kernels: str) -> dict:
    """Strength-reduce one LocalOp for the executor. Rows whose coefficients
    are uniform across processors split into three classes: all-zero rows
    write zeros, {0,1}-rows become pure madd chains (a pipelining pass's
    shadow copies and combines), and the remaining *general* rows are stacked
    into ONE batched contraction — a fold of row-batched Shoup multiplies in
    ``fused`` mode, or one ``gf_matmul_batched``/``butterfly_mac`` kernel
    launch in ``cuda`` mode. ``torch`` keeps the dense per-(i,j) loop."""
    c = np.asarray(step.coeffs)
    spec = {
        "update": step.update,
        "overlap": step.overlap,  # scheduling only: never changes the value
        "zero": (),
        "adds": (),
        "gen": tuple(range(len(step.out_slots))),
        "coef": None,
        "dense": kernels == "torch",
    }
    if spec["dense"]:
        spec["coef"] = bake(c)
        return spec
    ones = np.all(c == 1, axis=0)
    zeros = np.all(c == 0, axis=0)
    uniform01 = ones | zeros
    zero_rows, add_rows, gen_rows = [], [], []
    for i in range(c.shape[1]):
        if zeros[i].all():
            zero_rows.append(i)
        elif uniform01[i].all():
            add_rows.append((i, tuple(int(j) for j in np.nonzero(ones[i])[0])))
        else:
            gen_rows.append(i)
    spec["zero"] = tuple(zero_rows)
    spec["adds"] = tuple(add_rows)
    spec["gen"] = tuple(gen_rows)
    if gen_rows:
        spec["coef"] = bake(c[:, gen_rows, :])
    return spec


def _wait(dev: torch.device):
    """Wait until the device has finished the work issued so far (a span's
    bracket); the CPU runs torch ops synchronously and needs none."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# THE generic executor: any ScheduleIR whose rounds are permutations
# ---------------------------------------------------------------------------


def ir_encode(
    ir: ScheduleIR,
    *,
    q: int = M31,
    device=None,
    kernels: str | None = None,
    tracer=None,
    topo=None,
    metrics=None,
):
    """Executor of any :class:`ScheduleIR` on one device: row ``k`` of the
    ``(K, *payload)`` tensor runs processor ``k``'s program. Returns a
    callable ``x -> out`` that holds its baked constants on ``device``
    (``None``: the card) and moves its input there.

    Every port group of every round is one gather along dim 0; receive
    coefficients and LocalOp contractions are baked per-processor constants
    (with their Shoup duals). ``mode="store"`` groups must cover every
    processor (a partial permutation would zero-fill the rest);
    ``mode="add"`` groups may be partial — non-receivers add zeros, a no-op.
    All sends of a round read the pre-round state, and a slot that was never
    written reads as zero.

    Inputs/outputs are in DEVICE order; for an IR with a non-identity
    ``placement`` the caller permutes: row ``placement[k]`` holds logical
    packet k.

    ``kernels`` selects the LocalOp lowering: ``"cuda"`` routes general rows
    through the hand-written kernels (one row → ``butterfly_mac``, several →
    ``gf_matmul_batched``, both batched over the K processors), ``"fused"``
    uses one fold of row-batched Shoup multiplies per op, ``"torch"`` keeps
    the per-coefficient loop, and ``None`` picks ``"cuda"`` on a CUDA device
    and ``"fused"`` on the CPU. All three are bit-exact.

    An ``overlap=True`` LocalOp (emitted by ``topo.passes.pipeline_rounds``)
    runs, on a CUDA device, on a second stream: it is issued there after the
    work before it and the main stream waits for it just before the first
    step that reads one of its output slots, so its contraction runs beside
    the following round's gathers. Every tensor that crosses the two streams
    is handed to ``Tensor.record_stream``, so the caching allocator does not
    reuse its memory while the other stream may still read it. No step writes
    into an existing tensor, so the later steps cannot disturb what the
    second stream reads. On the CPU the ops run in order. The flag never
    changes a value.

    ``tracer`` (a :class:`repro_torch.obs.trace.Tracer`) opts into per-round
    telemetry: each CommRound (merged with an overlap LocalOp just before
    it, as the reference merges them into one dispatch) and each other
    LocalOp runs inside its own span, bracketed by ``torch.cuda.synchronize``
    on a CUDA device so that a span measures the work and not its launch.
    Each round span carries the round index, transfer count, port groups
    (``ppermutes``), slots on the wire, the α-β model's predicted µs on
    ``topo`` (default: the paper's flat network), and the busiest-link
    calibration features (level/msgs/elems) that ``repro_torch.obs.feed``
    refits α/β from. Measured round times also land in the ``metrics``
    registry (default: the process-local ``repro_torch.obs.metrics`` one) as
    ``encode.rounds``, ``encode.ppermutes``, ``encode.bytes_on_wire`` and
    ``encode.round_us{level=}``. With ``tracer=None`` (the default) nothing
    synchronises; tracing changes when the host waits, never the computed
    function.

    The callable carries ``ir`` (the schedule it runs), ``permute_count``
    (gathers per call, equal to ``ir_permute_count(ir)``), ``permutes_run``
    (gathers the last call really ran) and ``kernels`` (the resolved mode).
    """
    dev = resolve_device(device)
    kernels = _resolve_kernels(kernels, dev)
    K = ir.K

    def bake(arr):
        arr = np.asarray(arr).astype(np.uint32)
        return to_tensor(arr, dev), to_tensor(shoup_precompute(arr, q), dev)

    # ("comm", [(pairs, src_of_dst, non_receivers, src_slots, dst_slots, mode, coef)], round_no)
    # | ("local", out_slots, in_slots, spec)
    ops = []
    round_no = -1
    for step in ir.steps:
        if isinstance(step, CommRound):
            round_no += 1
            groups = []
            for g in round_port_groups(step):
                if g.mode == "store" and len(g.pairs) != K:
                    raise ValueError(
                        "store-mode port group must cover every processor "
                        f"(got {len(g.pairs)} of {K})"
                    )
                coef = None
                if g.coeffs_by_dst is not None:
                    c = np.ones((K, len(g.slots)), dtype=np.uint32)
                    for dst, cs in g.coeffs_by_dst.items():
                        if cs is not None:
                            c[dst] = cs
                    coef = bake(c)
                src_of_dst = np.zeros(K, dtype=np.int64)
                receives = np.zeros(K, dtype=bool)
                for src, dst in g.pairs:
                    src_of_dst[dst] = src
                    receives[dst] = True
                non_receivers = np.nonzero(~receives)[0]
                groups.append(
                    (
                        g.pairs,
                        torch.as_tensor(src_of_dst, device=dev),
                        torch.as_tensor(non_receivers, device=dev)
                        if non_receivers.size
                        else None,
                        tuple(ss for ss, _ in g.slots),
                        tuple(ds for _, ds in g.slots),
                        g.mode,
                        coef,
                    )
                )
            if groups:
                ops.append(("comm", groups, round_no))
        elif isinstance(step, LocalOp):
            if step.coeffs is None:
                raise ValueError(
                    "structure-only IR (LocalOp.coeffs=None) cannot execute — "
                    "recompile with the generator matrix"
                )
            ops.append(
                ("local", step.out_slots, step.in_slots, _lower_local(step, bake, kernels))
            )
        else:  # pragma: no cover
            raise TypeError(f"unknown IR step {type(step).__name__}")

    def apply_comm(groups, buf, zero, npay):
        updates = []
        for _, src_of_dst, non_receivers, src_slots, dst_slots, mode, coef in groups:
            payload = torch.stack([buf.get(s, zero) for s in src_slots], dim=1)
            recv = payload.index_select(0, src_of_dst)  # one port = one gather
            run.permutes_run += 1
            if non_receivers is not None:
                recv.index_fill_(0, non_receivers, 0)  # recv is a fresh tensor
            if coef is not None:
                recv = shoup_mul(recv, _bcast(coef[0], npay), _bcast(coef[1], npay), q)
            for i, ds in enumerate(dst_slots):
                updates.append((ds, recv[:, i], mode))
        for ds, v, mode in updates:  # sends all read pre-round state
            buf[ds] = v if mode == "store" else (madd(buf[ds], v, q) if ds in buf else v)
        return buf

    def apply_local(out_slots, in_slots, spec, buf, zero, npay):
        xs = [buf.get(s, zero) for s in in_slots]  # all reads pre-op
        new = dict(buf) if spec["update"] else {}
        if spec["dense"]:  # the per-coefficient "torch" loop
            c, csh = spec["coef"]
            for i, os_ in enumerate(out_slots):
                acc = None
                for j in range(len(in_slots)):
                    term = shoup_mul(
                        xs[j], _bcast(c[:, i, j], npay), _bcast(csh[:, i, j], npay), q
                    )
                    acc = term if acc is None else madd(acc, term, q)
                new[os_] = acc
            return new
        for i in spec["zero"]:
            new[out_slots[i]] = zero
        for i, js in spec["adds"]:
            acc = zero
            for j in js:
                acc = xs[j] if acc is zero else madd(acc, xs[j], q)
            new[out_slots[i]] = acc
        if spec["gen"]:
            c, csh = spec["coef"]
            if kernels == "cuda":
                # imported here: the kernel packages themselves import core.field
                from ..kernels.butterfly.ops import butterfly_mac
                from ..kernels.gf_matmul.ops import gf_matmul_batched

                P = math.prod(zero.shape[1:])
                if len(spec["gen"]) == 1:
                    parts = torch.stack(xs, dim=0).reshape(len(in_slots), K, P)
                    out = butterfly_mac(
                        parts, c[:, 0, :].contiguous(), csh[:, 0, :].contiguous(), q=q
                    )[:, None]  # (K, 1, P)
                else:
                    stacked = torch.stack(xs, dim=1).reshape(K, len(in_slots), P)
                    out = gf_matmul_batched(c, stacked, q=q)  # (K, n_gen, P)
                for r, i in enumerate(spec["gen"]):
                    new[out_slots[i]] = out[:, r].reshape(zero.shape)
            else:  # "fused": madd-fold of row-batched Shoup multiplies — each
                # term is (K, n_gen, *pay) and folds at once, so the full
                # (K, n_gen, n_in, *pay) product never exists
                acc = None
                for j in range(len(in_slots)):
                    term = shoup_mul(
                        xs[j][:, None], _bcast(c[:, :, j], npay), _bcast(csh[:, :, j], npay), q
                    )
                    acc = term if acc is None else madd(acc, term, q)
                for r, i in enumerate(spec["gen"]):
                    new[out_slots[i]] = acc[:, r]
        return new

    overlapping = dev.type == "cuda" and any(
        op[0] == "local" and op[3]["overlap"] for op in ops
    )
    side = torch.cuda.Stream(dev) if overlapping else None

    def reads(op) -> set:
        """The slots whose data ``op`` reads."""
        if op[0] == "local":
            return set(op[2])
        out = set()
        for _, _, _, src_slots, dst_slots, mode, _ in op[1]:
            out.update(src_slots)
            if mode == "add":
                out.update(dst_slots)
        return out

    def join(pending: dict, slots):
        """Make the main stream wait for the second-stream work that writes
        any of ``slots`` (all of it when ``slots`` is None)."""
        for s in list(pending) if slots is None else [s for s in slots if s in pending]:
            torch.cuda.current_stream(dev).wait_event(pending.pop(s))

    def apply_op(op, buf, zero, npay, pending):
        """One IR step on the slot buffer. ``pending`` maps a slot to the
        event after which the second stream has written it."""
        if pending:
            join(pending, reads(op))
        if op[0] == "comm":
            return apply_comm(op[1], buf, zero, npay)
        if side is None or not op[3]["overlap"]:
            return apply_local(op[1], op[2], op[3], buf, zero, npay)
        main = torch.cuda.current_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            new = apply_local(op[1], op[2], op[3], buf, zero, npay)
            done = torch.cuda.Event()
            done.record(side)
        for s in op[2]:  # inputs the second stream reads
            if s in buf:
                buf[s].record_stream(side)
        zero.record_stream(side)
        for s in op[1]:  # outputs the main stream will read
            new[s].record_stream(main)
            pending[s] = done
        return new

    def execute(x, zero, npay):
        """Run ``ops`` on x, untraced: nothing waits for the device."""
        buf = {INPUT_SLOT: x}
        pending: dict = {}
        for op in ops:
            buf = apply_op(op, buf, zero, npay, pending)
        join(pending, None)
        return buf.get(ir.out_slot, zero)

    traced = None
    if tracer is not None:
        traced = _traced_runner(ir, ops, apply_op, join, dev, tracer, topo, metrics)

    def run(x):
        x = to_tensor(x, dev)
        if x.ndim < 1 or x.shape[0] != K:
            raise ValueError(f"x must have shape ({K}, *payload), got {tuple(x.shape)}")
        run.permutes_run = 0
        zero = torch.zeros_like(x)
        npay = x.ndim - 1
        if traced is not None:
            return traced(x, zero, npay)
        return execute(x, zero, npay)

    run.ir = ir
    run.permute_count = sum(len(op[1]) for op in ops if op[0] == "comm")
    run.permutes_run = 0
    run.kernels = kernels
    run.device = dev
    return run


def _traced_runner(ir, ops, apply_op, join, dev, tracer, topo, metrics):
    """The opt-in per-round path of :func:`ir_encode`: the IR's steps in
    dispatch groups, each inside a tracer span bracketed by
    :func:`_wait`. Groups, span names and attributes are the reference's
    (``repro.dist.collectives._traced_runner``): an overlap LocalOp followed
    by a comm round is one group, ``round[r]`` spans carry the round's
    metadata, other LocalOps get ``local[i]`` spans, ``i`` being the group's
    index. The values are those of the untraced path."""
    if topo is None:
        topo = FullyConnected(ir.K)
    reg = metrics if metrics is not None else get_registry()

    grouped = []
    i = 0
    while i < len(ops):
        op = ops[i]
        if op[0] == "local" and op[3]["overlap"] and i + 1 < len(ops) and ops[i + 1][0] == "comm":
            grouped.append((op, ops[i + 1]))
            i += 2
        else:
            grouped.append((op,))
            i += 1

    # per-comm-group metadata: the round's message map and its derived stats
    comm_meta = {}
    for idx, grp in enumerate(grouped):
        op = next((o for o in grp if o[0] == "comm"), None)
        if op is None:
            continue
        msgs: dict = {}
        wire_slots = 0
        n_transfers = 0
        max_slots = 0
        for pairs, _, _, src_slots, _, _, _ in op[1]:
            n_transfers += len(pairs)
            wire_slots += len(pairs) * len(src_slots)
            max_slots = max(max_slots, len(src_slots))
            for s, d in pairs:
                msgs[(s, d)] = msgs.get((s, d), 0) + len(src_slots)
        feats = round_features([msgs], topo)
        overlap_op = next((o for o in grp if o[0] == "local"), None)
        comm_meta[idx] = {
            "round": op[2],
            "msgs_map": msgs,
            "transfers": n_transfers,
            "ppermutes": len(op[1]),
            "slots": max_slots,
            "wire_slots": wire_slots,
            "feature": feats[0] if feats else None,
            "overlap_out_slots": len(overlap_op[1]) if overlap_op else 0,
        }
    n_rounds = len(comm_meta)
    total_ppermutes = ir_permute_count(ir)

    def run_group(grp, buf, zero, npay):
        pending: dict = {}
        for op in grp:
            buf = apply_op(op, buf, zero, npay, pending)
        join(pending, None)
        _wait(dev)
        return buf

    def run(x, zero, npay):
        payload_elems = math.prod(int(d) for d in x.shape[1:])
        with tracer.span(
            "ir_encode",
            algorithm=ir.algorithm,
            K=ir.K,
            p=ir.p,
            rounds=n_rounds,
            ppermutes=total_ppermutes,
            payload_elems=payload_elems,
        ):
            buf = {INPUT_SLOT: x}
            _wait(dev)
            for idx, grp in enumerate(grouped):
                meta = comm_meta.get(idx)
                if meta is None:
                    with tracer.span(f"local[{idx}]", kind="local"):
                        buf = run_group(grp, buf, zero, npay)
                    continue
                pred_us = schedule_time(topo, [meta["msgs_map"]], payload_elems).total * 1e6
                feat = meta["feature"]
                attrs = {
                    "algorithm": ir.algorithm,
                    "comm_round": meta["round"],
                    "transfers": meta["transfers"],
                    "ppermutes": meta["ppermutes"],
                    "slots": meta["slots"],
                    "wire_slots": meta["wire_slots"],
                    "payload_elems": payload_elems,
                    "predicted_us": pred_us,
                }
                if meta["overlap_out_slots"]:
                    attrs["overlap"] = True
                    attrs["overlap_out_slots"] = meta["overlap_out_slots"]
                if feat is not None:
                    attrs.update(level=feat["level"], msgs=feat["msgs"], elems=feat["elems"])
                with tracer.span(f"round[{meta['round']}]", **attrs) as sp:
                    buf = run_group(grp, buf, zero, npay)
                reg.counter("encode.rounds").inc()
                reg.counter("encode.ppermutes").inc(meta["ppermutes"])
                reg.counter("encode.bytes_on_wire").inc(meta["wire_slots"] * payload_elems * 4)
                if feat is not None:
                    reg.histogram("encode.round_us", level=feat["level"]).observe(sp.dur_us)
                else:
                    reg.histogram("encode.round_us").observe(sp.dur_us)
            return buf.get(ir.out_slot, zero)

    return run


# ---------------------------------------------------------------------------
# universal prepare-and-shoot (§IV)
# ---------------------------------------------------------------------------


def shoot_round_slots(plan: PrepareShootPlan, t: int, rho: int):
    """(dst_slots, src_slots) for shoot round ``t`` (1-based), port ``rho``:
    receiver slot ``l`` (digit_t = 0, lower digits 0) absorbs sender slot
    ``l + rho·(p+1)^{t-1}``. Mirrors prepare_shoot.shoot_rounds exactly; the
    executor ships ONLY these slots (the paper's digit-t message slices).
    """
    return digit_reduction_slots(plan.n, plan.p, t, rho)


def expected_permute_count(plan: PrepareShootPlan) -> int:
    """Number of permutations ps_encode runs: p per prepare round plus one
    per non-empty (round, port) shoot slice — the plan/executor agreement
    contract. (The IR path runs exactly this in the regular m ≤ K regime
    and never more.)"""
    count = plan.Tp * plan.p
    for t in range(1, plan.Ts + 1):
        for rho in range(1, plan.p + 1):
            dst, _ = shoot_round_slots(plan, t, rho)
            if dst.size:
                count += 1
    return count


def _apply_pipeline(ir: ScheduleIR, pipeline: str, payload_elems: int = 1 << 16):
    """Apply a named ``topo.passes`` pipeline at dispatch time (e.g.
    ``pipeline="pipeline"`` for the software-pipelined rounds). Priced
    against a flat fabric at a representative payload, exactly as the
    reference prices it, so the rewritten IR is the reference's; comm rounds
    are never touched, so the entry point's permutation budget still binds
    the rewritten IR."""
    if not pipeline:
        return ir
    return PIPELINES[pipeline].apply(ir, FullyConnected(ir.K), payload_elems)


def _check_budget(ir: ScheduleIR, budget: int):
    n = ir_permute_count(ir)
    if n > budget:
        raise AssertionError(
            f"{ir.algorithm} IR needs {n} permutations, committed budget is {budget}"
        )


def _square(A) -> np.ndarray:
    A = np.asarray(A)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"A must be square (K, K), got {A.shape}")
    return A


def ps_encode(
    A: np.ndarray,
    *,
    p: int = 1,
    q: int = M31,
    device=None,
    kernels: str | None = None,
    pipeline: str = "",
):
    """Executor of the universal encode: ``out = x @ A`` over GF(q) for ANY
    K×K matrix A, K = A.shape[0].

    Returns ``(fn, plan)``; ``fn`` maps a ``(K, *payload)`` tensor to the
    encoded tensor of the same shape. A is a host array: the IR's
    coefficients and their Shoup duals are baked in as device constants.
    ``pipeline`` names a ``topo.passes.PIPELINES`` entry applied to the IR
    first (``""``: none).
    """
    A = _square(A)
    plan = plan_prepare_shoot(A.shape[0], p)
    ir = _apply_pipeline(plan.to_ir(A, q=q), pipeline)
    _check_budget(ir, expected_permute_count(plan))
    return ir_encode(ir, q=q, device=device, kernels=kernels), plan


def allgather_encode(A: np.ndarray, *, q: int = M31, device=None):
    """Baseline encode: every processor sees every packet, then contracts
    locally with its own column of A — C1 = O(log K) but C2 = Θ(K/p). Kept as
    the cost-model foil for ps_encode (deliberately NOT routed through
    ir_encode, and plain torch: its point is the gather the IR path never
    does)."""
    A = _square(A)
    K = A.shape[0]
    dev = resolve_device(device)
    # processor k needs column A[:, k]: cols[k, j] = A[j, k]
    cols_np = np.ascontiguousarray(A.T).astype(np.uint32)
    cols = to_tensor(cols_np, dev)
    cols_sh = to_tensor(shoup_precompute(cols_np, q), dev)

    def run(x):
        x = to_tensor(x, dev)
        if x.shape[0] != K:
            raise ValueError(f"x must have shape ({K}, *payload), got {tuple(x.shape)}")
        npay = x.ndim - 1
        acc = None
        for j in range(K):
            term = shoup_mul(x[j][None], _bcast(cols[:, j], npay), _bcast(cols_sh[:, j], npay), q)
            acc = term if acc is None else madd(acc, term, q)
        return acc

    return run


# ---------------------------------------------------------------------------
# two-level hierarchical encode
# ---------------------------------------------------------------------------


def expected_hier_permute_count(plan) -> int:
    """Permutation budget of hierarchical_encode: one per non-empty intra
    gather port plus one per inter (round, port) with live slots — the
    plan/executor agreement contract (mirrors expected_permute_count)."""
    count = sum(len(ports) for ports in plan.intra_rounds)
    for t in range(1, len(plan.inter_shifts) + 1):
        for rho in range(1, plan.p + 1):
            if hier_shoot_message_size(plan, t, rho):
                count += 1
    return count


def hierarchical_encode(
    A: np.ndarray,
    *,
    k_intra: int,
    p: int = 1,
    q: int = M31,
    device=None,
    kernels: str | None = None,
    pipeline: str = "",
):
    """Two-level executor of the universal encode: ``out = x @ A`` over GF(q)
    for ANY K×K matrix A, K = G × I with I = ``k_intra``; row ``k = g·I + i``
    is the reference's device (g, i).

    Three phases (``topo.hierarchical`` — the topology-aligned schedule):
    (p+1)-ary doubling all-gather inside each group of I, a local Shoup
    contraction against baked per-processor coefficients, then the §IV
    digit-reduction shoot across the G groups. Bit-exact vs. ``ps_encode``
    and the oracle (modular sums reassociate exactly). The two-level
    schedule is the depth-2 case of the recursive one, so
    ``HierarchicalPlan.to_ir`` compiles through the multilevel IR builder.

    Returns ``(fn, plan)`` with plan a :class:`HierarchicalPlan`.
    """
    A = _square(A)
    plan = plan_hierarchical(A.shape[0], p, k_intra=k_intra)
    ir = _apply_pipeline(plan.to_ir(A, q=q), pipeline)
    _check_budget(ir, expected_hier_permute_count(plan))
    return ir_encode(ir, q=q, device=device, kernels=kernels), plan


# ---------------------------------------------------------------------------
# recursive multi-level encode
# ---------------------------------------------------------------------------


def expected_multilevel_permute_count(plan) -> int:
    """Permutation budget of multilevel_encode: one per non-empty intra
    gather port plus one per (level, round, port) with live slots — the
    plan/executor agreement contract (mirrors expected_hier_permute_count)."""
    count = sum(len(ports) for ports in plan.intra_rounds)
    for j in range(1, len(plan.levels)):
        for t in range(1, len(plan.level_shifts[j - 1]) + 1):
            for rho in range(1, plan.p + 1):
                if multilevel_message_size(plan, j, t, rho):
                    count += 1
    return count


def multilevel_encode(
    A: np.ndarray,
    sizes,
    *,
    p: int = 1,
    q: int = M31,
    device=None,
    kernels: str | None = None,
    pipeline: str = "",
):
    """N-level executor of the universal encode: ``out = x @ A`` over GF(q)
    for ANY K×K matrix A, K = Π ``sizes``.

    ``sizes`` is ordered outermost (slowest links) → innermost (fastest), as
    the reference's mesh ``axes``: the last size varies fastest, so row
    (c_{L−1}, …, c_1, c_0) is packet k = c_0 + K_0·(c_1 + K_1·(…)) and the
    plan's ``levels`` are ``reversed(sizes)``.

    Phases (``topo.hierarchical`` — the recursive topology-aligned schedule):
    (p+1)-ary doubling all-gather over the innermost level, a local Shoup
    contraction against baked per-processor coefficients, then one §IV
    digit-reduction shoot per outer level, innermost first — every round
    permutes exactly ONE level's coordinate. Bit-exact vs. ``ps_encode`` and
    the oracle. With two sizes this is exactly :func:`hierarchical_encode`'s
    schedule.

    Returns ``(fn, plan)`` with plan a :class:`MultiLevelPlan`.
    """
    sizes = tuple(int(s) for s in sizes)
    K = math.prod(sizes)
    A = _square(A)
    if A.shape != (K, K):
        raise ValueError(f"A must be ({K}, {K}) to match sizes {sizes!r}, got {A.shape}")
    plan = plan_multilevel(K, p, tuple(reversed(sizes)))
    ir = _apply_pipeline(plan.to_ir(A, q=q), pipeline)
    _check_budget(ir, expected_multilevel_permute_count(plan))
    return ir_encode(ir, q=q, device=device, kernels=kernels), plan


# ---------------------------------------------------------------------------
# radix-(p+1) DFT butterfly (§V-A)
# ---------------------------------------------------------------------------


def butterfly(
    K: int,
    *,
    p: int = 1,
    q: int = NTT,
    inverse: bool = False,
    device=None,
    kernels: str | None = None,
    pipeline: str = "",
):
    """Butterfly executor: forward computes ``x @ butterfly_target_matrix``
    (the digit-reversed K-point DFT), inverse undoes it exactly (Lemma 5).

    Returns ``(fn, plan)``. Round t exchanges within digit-t groups via p
    permutations (one per port group of the butterfly IR) and combines with
    the plan's (inverse) twiddles — C1 = C2 = H rounds/elements, mirroring
    core/draw_loose.butterfly_apply. ``pipeline`` as for :func:`ps_encode`.
    """
    plan = plan_butterfly(K, p, q)
    ir = _apply_pipeline(plan.to_ir(inverse=inverse), pipeline)
    _check_budget(ir, plan.H * p)
    return ir_encode(ir, q=q, device=device, kernels=kernels), plan
