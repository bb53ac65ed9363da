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
``plan.to_ir()``, and hand the IR to the generic executor — round structure,
coefficient tables and masks all come from the SAME plans as the host
simulator, so this path and the oracle agree bit for bit by construction.

Communication discipline: the executor runs one permutation per port group
and counts them (``fn.permutes_run`` after a call, ``fn.permute_count``
statically); the committed budgets (:func:`expected_permute_count` and
``H·p`` for the butterfly) are asserted at dispatch time
(``ir_permute_count(ir) ≤ budget``).

:func:`allgather_encode` is the deliberate baseline that DOES gather every
packet to every processor, kept as the cost-model foil.

Tensors are ``int32`` bit patterns of canonical residues (``core.field``).
Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``torch.device("cuda")``, a CPU tensor or numpy array
handed to the returned callable is moved there, and with no card the call
raises.

Paper-notation glossary: ``K`` processors, ``p`` ports per round (each
permutation is one port), ``C1`` rounds, ``C2`` per-port elements;
*digit-reduction slots* — the §IV shoot buffer layout (one slot per
(p+1)-ary numeral of the remaining target offset; round t zeroes digit t by
shipping the slots with digit_t = ρ on port ρ).
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

__all__ = [
    "KERNEL_MODES",
    "ir_encode",
    "ps_encode",
    "allgather_encode",
    "butterfly",
    "shoot_round_slots",
    "expected_permute_count",
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


# ---------------------------------------------------------------------------
# THE generic executor: any ScheduleIR whose rounds are permutations
# ---------------------------------------------------------------------------


def ir_encode(
    ir: ScheduleIR,
    *,
    q: int = M31,
    device=None,
    kernels: str | None = None,
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

    The callable carries ``permute_count`` (gathers per call, equal to
    ``ir_permute_count(ir)``), ``permutes_run`` (gathers the last call
    really ran) and ``kernels`` (the resolved mode).
    """
    dev = resolve_device(device)
    kernels = _resolve_kernels(kernels, dev)
    K = ir.K

    def bake(arr):
        arr = np.asarray(arr).astype(np.uint32)
        return to_tensor(arr, dev), to_tensor(shoup_precompute(arr, q), dev)

    # ("comm", [(src_of_dst, non_receivers, src_slots, dst_slots, mode, coef)])
    # | ("local", out_slots, in_slots, spec)
    ops = []
    for step in ir.steps:
        if isinstance(step, CommRound):
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
                ops.append(("comm", groups))
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
        for src_of_dst, non_receivers, src_slots, dst_slots, mode, coef in groups:
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

    def run(x):
        x = to_tensor(x, dev)
        if x.ndim < 1 or x.shape[0] != K:
            raise ValueError(f"x must have shape ({K}, *payload), got {tuple(x.shape)}")
        run.permutes_run = 0
        npay = x.ndim - 1
        zero = torch.zeros_like(x)
        buf = {INPUT_SLOT: x}
        for op in ops:
            if op[0] == "comm":
                buf = apply_comm(op[1], buf, zero, npay)
            else:
                buf = apply_local(op[1], op[2], op[3], buf, zero, npay)
        return buf.get(ir.out_slot, zero)

    run.permute_count = sum(len(op[1]) for op in ops if op[0] == "comm")
    run.permutes_run = 0
    run.kernels = kernels
    run.device = dev
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


def _check_budget(ir: ScheduleIR, budget: int):
    n = ir_permute_count(ir)
    if n > budget:
        raise AssertionError(
            f"{ir.algorithm} IR needs {n} permutations, committed budget is {budget}"
        )


def ps_encode(
    A: np.ndarray,
    *,
    p: int = 1,
    q: int = M31,
    device=None,
    kernels: str | None = None,
):
    """Executor of the universal encode: ``out = x @ A`` over GF(q) for ANY
    K×K matrix A, K = A.shape[0].

    Returns ``(fn, plan)``; ``fn`` maps a ``(K, *payload)`` tensor to the
    encoded tensor of the same shape. A is a host array: the IR's
    coefficients and their Shoup duals are baked in as device constants.
    """
    A = np.asarray(A)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"A must be square (K, K), got {A.shape}")
    K = A.shape[0]
    plan = plan_prepare_shoot(K, p)
    ir = plan.to_ir(A, q=q)
    _check_budget(ir, expected_permute_count(plan))
    return ir_encode(ir, q=q, device=device, kernels=kernels), plan


def allgather_encode(A: np.ndarray, *, q: int = M31, device=None):
    """Baseline encode: every processor sees every packet, then contracts
    locally with its own column of A — C1 = O(log K) but C2 = Θ(K/p). Kept as
    the cost-model foil for ps_encode (deliberately NOT routed through
    ir_encode, and plain torch: its point is the gather the IR path never
    does)."""
    A = np.asarray(A)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"A must be square (K, K), got {A.shape}")
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
):
    """Butterfly executor: forward computes ``x @ butterfly_target_matrix``
    (the digit-reversed K-point DFT), inverse undoes it exactly (Lemma 5).

    Returns ``(fn, plan)``. Round t exchanges within digit-t groups via p
    permutations (one per port group of the butterfly IR) and combines with
    the plan's (inverse) twiddles — C1 = C2 = H rounds/elements, mirroring
    core/draw_loose.butterfly_apply.
    """
    plan = plan_butterfly(K, p, q)
    ir = plan.to_ir(inverse=inverse)
    _check_budget(ir, plan.H * p)
    return ir_encode(ir, q=q, device=device, kernels=kernels), plan
