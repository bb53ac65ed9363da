"""Cost-exact synchronous p-port network simulator (paper §I model) — now a
single generic :func:`interpret` over :class:`~repro_torch.core.ir.ScheduleIR`.

Every algorithm family compiles to the same IR (``core/ir.py``), and ONE
interpreter executes any IR message-by-message under the exact §I
constraints: every round is validated against the p-port limits (each
processor sends ≤ p and receives ≤ p messages, no self-messages) and C1/C2
are counted exactly as defined:

    C1 = number of rounds
    C2 = Σ_t max_{messages m in round t} len(m)     (field elements)

The per-family ``simulate_*`` entry points are thin wrappers over
``interpret(plan.to_ir(...))`` — kept for API compatibility and because they
assert bit-exactness against the matrix oracle whenever the generator is at
hand (the transition guarantee of the IR refactor). The array-level torch
executors in ``prepare_shoot.py`` / ``draw_loose.py`` are cross-checked
against both this interpreter and the matrix oracle.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np

from .field import Field
from .ir import INPUT_SLOT, CommRound, LocalOp, ScheduleIR, validate_round
from .schedule import ButterflyPlan, DrawLoosePlan, PrepareShootPlan


@dataclass
class SimStats:
    K: int
    p: int
    C1: int = 0
    C2: int = 0
    round_sizes: list = dc_field(default_factory=list)
    total_elements: int = 0  # Σ over all messages (not just max) — extra info
    # per-round message map {(src, dst): elements} — the exact communication
    # pattern; equals ``ir_messages(plan.to_ir())`` message-for-message (the
    # lowering a topology model prices)
    round_messages: list = dc_field(default_factory=list)


class SyncSimulator:
    """Executes one communication round at a time, enforcing the model."""

    def __init__(self, K: int, p: int):
        self.stats = SimStats(K=K, p=p)

    def exchange(self, messages: dict) -> dict:
        """messages: {(src, dst): list_of_elements}. Returns them 'delivered'.

        Empty rounds are not allowed (the model counts a round only when
        communication happens; algorithms never schedule empty rounds).
        """
        K, p = self.stats.K, self.stats.p
        if not messages:
            raise ValueError("empty communication round")
        out_count: dict[int, int] = {}
        in_count: dict[int, int] = {}
        for (src, dst), payload in messages.items():
            if src == dst:
                raise ValueError(f"self-message at processor {src}")
            if not (0 <= src < K and 0 <= dst < K):
                raise ValueError("processor index out of range")
            if len(payload) == 0:
                raise ValueError("empty message")
            out_count[src] = out_count.get(src, 0) + 1
            in_count[dst] = in_count.get(dst, 0) + 1
        if max(out_count.values()) > p:
            raise ValueError(f"a processor sends more than p={p} messages")
        if max(in_count.values()) > p:
            raise ValueError(f"a processor receives more than p={p} messages")
        d = max(len(v) for v in messages.values())
        self.stats.C1 += 1
        self.stats.C2 += d
        self.stats.round_sizes.append(d)
        self.stats.total_elements += sum(len(v) for v in messages.values())
        self.stats.round_messages.append(
            {pair: len(v) for pair, v in messages.items()}
        )
        return messages


# ---------------------------------------------------------------------------
# THE interpreter: any ScheduleIR, message-by-message, cost-exact
# ---------------------------------------------------------------------------


def interpret(
    ir: ScheduleIR, x: np.ndarray, field: Field, *, tracer=None, topo=None
) -> tuple[np.ndarray, SimStats]:
    """Execute ``ir`` on input ``x`` (shape (K,), uint64 canonical mod q)
    under the p-port constraints; returns (output, stats). Inputs and
    outputs are in LOGICAL processor order — ``ir.placement`` (set by layout
    passes built on ``relabel``) is applied at the boundary.

    ``tracer`` (a :class:`repro_torch.obs.trace.Tracer`) opts into per-round
    spans mirroring the executor's instrumentation: one span per CommRound
    with its round index, transfer count, and largest message (host wall
    time here measures the interpreter itself, not a network — useful for
    tracing schedule structure, not for calibration); ``topo`` (a
    :class:`repro_torch.topo.model.Topology`) additionally stamps the α-β
    model's ``predicted_us`` on each round span."""
    K = ir.K
    x = field.asarray(np.asarray(x))
    if x.shape != (K,):
        raise ValueError(f"x must have shape ({K},), got {x.shape}")
    place = (
        np.asarray(ir.placement, dtype=np.int64)
        if ir.placement is not None
        else np.arange(K)
    )
    sim = SyncSimulator(K, ir.p)
    zero = np.uint64(0)
    buf: list[dict] = [{} for _ in range(K)]
    for k in range(K):
        buf[place[k]][INPUT_SLOT] = x[k]
    from contextlib import nullcontext

    root = (
        tracer.span("interpret", algorithm=ir.algorithm, K=K, p=ir.p)
        if tracer is not None
        else nullcontext()
    )
    round_no = -1
    with root:
        for step in ir.steps:
            if isinstance(step, CommRound):
                validate_round(step)
                round_no += 1
                msgs: dict = {}
                modes: dict = {}
                for t in step.transfers:
                    payload = []
                    for i, (ss, ds) in enumerate(t.slots):
                        c = t.coeffs[i] if t.coeffs is not None else 1
                        payload.append((ds, c, buf[t.src].get(ss, zero)))
                    msgs[(t.src, t.dst)] = payload
                    modes[(t.src, t.dst)] = t.mode
                span = nullcontext()
                if tracer is not None:
                    attrs = {
                        "algorithm": ir.algorithm,
                        "comm_round": round_no,
                        "transfers": len(step.transfers),
                        "slots": max(len(v) for v in msgs.values()),
                        "payload_elems": 1,
                    }
                    if topo is not None:
                        from ..topo.model import schedule_time

                        attrs["predicted_us"] = (
                            schedule_time(
                                topo, [{p_: len(v) for p_, v in msgs.items()}]
                            ).total
                            * 1e6
                        )
                    span = tracer.span(f"round[{round_no}]", **attrs)
                with span:
                    delivered = sim.exchange(msgs)
                    for pair, payload in delivered.items():
                        dst = pair[1]
                        store = modes[pair] == "store"
                        for ds, c, v in payload:
                            if c != 1:
                                v = field.mul(np.uint64(c), v)
                            if store:
                                buf[dst][ds] = v
                            else:
                                buf[dst][ds] = field.add(
                                    buf[dst].get(ds, zero), v
                                )
            elif isinstance(step, LocalOp):
                if step.coeffs is None:
                    raise ValueError(
                        "structure-only IR (LocalOp.coeffs=None) cannot be "
                        "interpreted — recompile with the generator matrix"
                    )
                n_in = len(step.in_slots)
                cols = np.zeros((K, n_in), dtype=np.uint64)
                for j, s in enumerate(step.in_slots):
                    for k in range(K):
                        cols[k, j] = buf[k].get(s, zero)
                out = np.zeros((K, len(step.out_slots)), dtype=np.uint64)
                for j in range(n_in):
                    out = field.add(
                        out, field.mul(step.coeffs[:, :, j], cols[:, j][:, None])
                    )
                for k in range(K):
                    if step.update:
                        for i, s in enumerate(step.out_slots):
                            buf[k][s] = out[k, i]
                    else:
                        buf[k] = {s: out[k, i] for i, s in enumerate(step.out_slots)}
            else:  # pragma: no cover
                raise TypeError(f"unknown IR step {type(step).__name__}")
    result = np.array(
        [buf[place[k]].get(ir.out_slot, zero) for k in range(K)], dtype=np.uint64
    )
    return result, sim.stats


# ---------------------------------------------------------------------------
# per-family wrappers (compile → interpret; oracle-asserted when A is known)
# ---------------------------------------------------------------------------


def simulate_prepare_shoot(
    x: np.ndarray, A: np.ndarray, plan: PrepareShootPlan, field: Field
) -> tuple[np.ndarray, SimStats]:
    """x: (K,) uint64, A: (K,K) uint64 over ``field``. Returns (x̃, stats)."""
    out, stats = interpret(plan.to_ir(A, q=field.q), x, field)
    np.testing.assert_array_equal(out, field.matmul(field.asarray(x), A))
    return out, stats


def simulate_butterfly(
    v: np.ndarray, plan: ButterflyPlan, field: Field, inverse: bool = False
) -> tuple[np.ndarray, SimStats]:
    """Round t: every processor broadcasts its Q to the p digit-t partners
    and combines the radix received values (own + p) with the twiddle row."""
    return interpret(plan.to_ir(inverse=inverse), v, field)


def simulate_draw_loose(
    x: np.ndarray, plan: DrawLoosePlan, field: Field
) -> tuple[np.ndarray, SimStats]:
    """Draw phase (Z parallel M-sized prepare-and-shoots, merged round-by-
    round so the port constraints are checked globally), the local scale,
    then the loose phase (M parallel Z-point butterflies, also merged)."""
    return interpret(plan.to_ir(), x, field)
