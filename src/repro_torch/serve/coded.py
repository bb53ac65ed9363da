"""Coded straggler-tolerant serving: LCC-protected decode state.

The paper's all-to-all encode exists so decentralized computation survives
failures; this module wires it into the continuous-batching engine
(``ContinuousEngine.serve(guard=)``). The decode-path state — every layer's
KV-cache slab and the per-slot decode state (last tokens, positions, the
bool ``active`` mask, token buffers, counters and the int32 ``rng`` seed
pairs of the sampling streams), or any ``(cache, state)`` pytree of tensors
— is flattened to field limbs, sharded K ways, and encoded into **N = K + R
coded replicas** with the padded Lagrange/Vandermonde generator
(``repro_torch.coded.lcc_encode`` — one universal prepare-and-shoot
all-to-all encode; with ``collective=True`` the same generator runs as the
compiled round schedule of ``dist.collectives.ps_encode``, the N hosts being
the tensor's first axis; with ``mesh=``/``axis=`` as the rank executor
``coded.lcc_encode_ranks``, one host a rank of an N-wide mesh axis). Each
coded shard is owned by one simulated "host".

On a mesh of ranks every rank runs the engine and calls the guard. A state
whose leaves are ``DTensor`` s is read by its global value; the mesh's first
rank (the host axis's first, with ``mesh=``) alone holds the coded shards and
the :class:`CodedDecodeGroup`, decides which hosts died and rebuilds the
state, and every rank gets the same answer from it: the same dead hosts from
:meth:`CodedServeGuard.poll`, the same whole state from
:meth:`CodedServeGuard.recover`.

A :class:`FaultInjector` kills hosts at scheduled decode ticks (or a
:class:`ProcessHostPool` host — a real OS process holding its shard — is
SIGKILLed). The engine detects the fault at the next chunk sync,
:class:`CodedServeGuard` reconstructs the exact chunk-start state from any
K of the surviving shards via Lagrange interpolation
(``repro_torch.coded.lcc_decode``, host numpy), and the chunk replays
deterministically — requests in flight on the dead host are **recovered,
not dropped**, and the emitted token stream is bit-identical to an unfailed
run.

Observability: ``serve.recoveries`` (hosts recovered from), ``serve.
recovery_us`` (reconstruction latency histogram), ``serve.snapshots``,
and a ``serve.recovery`` span per event when a tracer is attached
(``repro_torch.obs`` objects).
"""

from __future__ import annotations

import base64
import contextlib
import functools
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..coded.lagrange_compute import (
    build_lcc,
    lcc_decode,
    lcc_encode,
    lcc_encode_collective,
    lcc_encode_ranks,
    lcc_pad,
)
from ..coded.rs_checkpoint import (
    broadcast_state,
    encode_state,
    gather_state,
    mesh_group,
    on_root,
    state_limb_row,
    state_meta,
    unshard_state_limbs,
)
from ..core.field import NTT, resolve_device, to_numpy, to_tensor

#: seconds a host process is given to end once asked to
_CLOSE_TIMEOUT_S = 10.0


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------


@dataclass
class FaultInjector:
    """Deterministic fault schedule: kill host ``h`` once decode tick ``t``
    has completed. ``due(now)`` returns the not-yet-fired kills with
    ``t < now`` (the chunk that crossed tick t detects them at its sync)."""

    kills: tuple[tuple[int, int], ...]  # (tick, host) pairs
    _fired: set = field(default_factory=set)

    def due(self, now_tick: int) -> list[tuple[int, int]]:
        out = []
        for i, (t, h) in enumerate(self.kills):
            if i not in self._fired and t < now_tick:
                self._fired.add(i)
                out.append((t, h))
        return out

    @property
    def injected(self) -> int:
        """Faults fired so far."""
        return len(self._fired)


# ---------------------------------------------------------------------------
# host processes (the SIGKILL-able variant)
# ---------------------------------------------------------------------------

#: the whole host program: store one shard, serve it back on request. No
#: imports of this package — a host is just memory that can die.
_HOST_LOOP = r"""
import sys
store = None
for line in sys.stdin:
    line = line.strip()
    if not line:
        continue
    cmd, _, arg = line.partition(" ")
    if cmd == "put":
        store = arg
        sys.stdout.write("ok\n")
    elif cmd == "get":
        sys.stdout.write(("none" if store is None else store) + "\n")
    elif cmd == "quit":
        break
    else:
        sys.stdout.write("err\n")
    sys.stdout.flush()
"""


class ProcessHostPool:
    """N coded-shard hosts, each a separate OS process holding its shard in
    its own memory over a line pipe — so a ``SIGKILL`` is a *real* host
    loss, not a simulation flag. Store/fetch failures (dead pipe, EOF)
    report the host dead rather than raising."""

    def __init__(self, n_hosts: int):
        self.procs = [
            subprocess.Popen(
                [sys.executable, "-c", _HOST_LOOP],
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                text=True,
                bufsize=1,
            )
            for _ in range(n_hosts)
        ]

    def __len__(self) -> int:
        return len(self.procs)

    def alive(self, host: int) -> bool:
        return self.procs[host].poll() is None

    def store(self, host: int, shard: np.ndarray) -> bool:
        p = self.procs[host]
        if p.poll() is not None:
            return False
        payload = base64.b64encode(
            np.ascontiguousarray(shard, dtype=np.uint32).tobytes()
        ).decode()
        try:
            p.stdin.write(f"put {payload}\n")
            p.stdin.flush()
            return p.stdout.readline().strip() == "ok"
        except (BrokenPipeError, OSError, ValueError):
            return False

    def fetch(self, host: int) -> np.ndarray | None:
        p = self.procs[host]
        if p.poll() is not None:
            return None
        try:
            p.stdin.write("get\n")
            p.stdin.flush()
            line = p.stdout.readline().strip()
        except (BrokenPipeError, OSError, ValueError):
            return None
        if not line or line in ("none", "err"):
            return None
        return np.frombuffer(base64.b64decode(line), dtype=np.uint32).copy()

    def kill(self, host: int, sig: int = signal.SIGKILL) -> None:
        p = self.procs[host]
        if p.poll() is None:
            p.send_signal(sig)
            p.wait(timeout=_CLOSE_TIMEOUT_S)  # the host is DEAD before the caller carries on

    def close(self) -> None:
        """Ask every live host to quit, then make sure it has ended: a host
        that does not end within the timeout is killed."""
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.stdin.write("quit\n")
                    p.stdin.flush()
                except (BrokenPipeError, OSError, ValueError):
                    pass
                p.terminate()
            try:
                p.wait(timeout=_CLOSE_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            for pipe in (p.stdin, p.stdout):
                with contextlib.suppress(OSError, ValueError):
                    pipe.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# the K-of-N decode group
# ---------------------------------------------------------------------------


class CodedDecodeGroup:
    """The N = K + R coded shard holders and the any-K-of-N reconstruction.

    A "host" is either an in-memory slot (default) or one
    :class:`ProcessHostPool` child process. The group hands coded shard j
    to host j after each encode, tracks which hosts are alive, and
    rebuilds all K data shards from the first K survivors via Lagrange
    interpolation (``repro_torch.coded.lcc_decode``, host numpy)."""

    def __init__(self, plan, hosts: ProcessHostPool | None = None):
        if hosts is not None and len(hosts) != plan.N:
            raise ValueError(
                f"host pool has {len(hosts)} hosts, need N={plan.N}"
            )
        self.plan = plan
        self.hosts = hosts
        self.alive: set[int] = set(range(plan.N))
        self._mem: dict[int, np.ndarray] = {}

    def store(self, coded: np.ndarray) -> None:
        """Hand coded row j to host j; a host found dead mid-store is
        dropped from the alive set, not raised on."""
        self._mem = {}
        for j in sorted(self.alive):
            if self.hosts is not None:
                if not self.hosts.store(j, coded[j]):
                    self.alive.discard(j)
            else:
                self._mem[j] = np.asarray(coded[j], dtype=np.uint32)

    def kill(self, host: int) -> bool:
        """Take host down (SIGKILL when it is a process). Returns whether
        it was alive — dead hosts can't die twice."""
        if host not in self.alive:
            return False
        if self.hosts is not None:
            self.hosts.kill(host)
        self.alive.discard(host)
        return True

    def scan(self) -> list[int]:
        """Detect hosts that died without the injector's help (process
        pools only — an in-memory slot can't die by itself)."""
        if self.hosts is None:
            return []
        dead = [h for h in sorted(self.alive) if not self.hosts.alive(h)]
        self.alive.difference_update(dead)
        return dead

    def reconstruct(self) -> np.ndarray:
        """All K data shards, bit-exact, from the first K surviving coded
        shards. Raises RuntimeError when fewer than K survive — past the
        code's R-failure tolerance there is nothing to interpolate."""
        values, responders = [], []
        for j in sorted(self.alive):
            if self.hosts is not None:
                v = self.hosts.fetch(j)
                if v is None:  # died between scan and fetch
                    self.alive.discard(j)
                    continue
            else:
                v = self._mem.get(j)
                if v is None:
                    continue
            values.append(v)
            responders.append(j)
            if len(responders) == self.plan.K:
                break
        if len(responders) < self.plan.K:
            raise RuntimeError(
                f"{len(responders)} coded shards survive, need "
                f"K={self.plan.K} (R={self.plan.R} tolerates at most "
                f"{self.plan.R} lost hosts)"
            )
        return lcc_decode(self.plan, np.stack(values), responders)


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------


class CodedServeGuard:
    """``train.elastic.CodedStateGuard``'s pattern extended to serving:
    snapshot the decode-path state as N = K + R LCC shards every decode
    chunk, and rebuild the exact chunk-start state from any K survivors
    after a host loss. An engine calls :meth:`snapshot` before each decode
    chunk, :meth:`poll` at the chunk sync, and :meth:`recover` + chunk
    replay when a host died.

    The limbs and the encode run on ``device`` (``None``: the card;
    ``"cpu"`` runs the plain path) block of columns by block
    (``coded.rs_checkpoint.encode_state``); the coded shards are copied to
    the host block by block and handed out from there. ``hosts=`` (a
    :class:`ProcessHostPool`) stores each shard in its own OS process — the
    injector then delivers real SIGKILLs, and externally killed hosts are
    detected at :meth:`poll` too. ``collective=True`` runs the encode through
    the compiled round schedule (``coded.lcc_encode_collective``) instead of
    the single-program encode; ``kernels=`` picks that executor's LocalOp
    lowering, as in ``dist.collectives``.

    ``mesh=``/``axis=`` (a ``launch.mesh.RankMesh`` whose axis ``axis``
    holds N ranks over gloo) runs the encode on the ranks
    (``coded.lcc_encode_ranks``; ``kernels=`` its lowering): the rank at
    index j of ``axis`` builds row j of the padded limb shards (zeros for
    j ≥ K) and encodes it, and the N coded rows are gathered to the axis's
    first rank, whose :class:`CodedDecodeGroup` (and ``hosts=`` pool: give
    it on that rank alone) stores them. Every rank of the mesh constructs
    the guard and calls its methods. The guard computes on the mesh's
    device unless ``device`` says otherwise."""

    def __init__(
        self,
        K: int,
        R: int = 1,
        p: int = 1,
        q: int = NTT,
        injector: FaultInjector | None = None,
        hosts: ProcessHostPool | None = None,
        collective: bool = False,
        kernels: str | None = None,
        device=None,
        mesh=None,
        axis: str | None = None,
    ):
        if R < 1:
            raise ValueError("coded serving needs R ≥ 1 parity shards")
        if mesh is not None and axis is None:
            raise ValueError("mesh= requires axis=")
        if mesh is not None and collective:
            raise ValueError("mesh= runs the encode on the ranks: collective=True is the one-card schedule")
        if kernels is not None and not collective and mesh is None:
            raise ValueError("kernels= selects the collective executor's lowering: pass collective=True")
        self.device = resolve_device(device if device is not None or mesh is None else mesh.device)
        self.plan = build_lcc(K, p=p, q=q, R=R)
        self.K, self.R, self.N = K, R, K + R
        self.injector = injector
        self.group = CodedDecodeGroup(self.plan, hosts=hosts)
        #: the compiled round schedule's callable when ``collective``
        self._collective = (
            lcc_encode_collective(self.plan, device=self.device, kernels=kernels) if collective else None
        )
        #: the rank executor's callable, this rank's host index and the
        #: (group, first rank) of the host axis, with ``mesh=``
        self._ranks = lcc_encode_ranks(mesh, axis, self.plan, kernels=kernels) if mesh is not None else None
        self._host = mesh.index(axis) if mesh is not None else None
        self._mesh = (mesh.axis_group(axis), mesh.peer(axis, 0)) if mesh is not None else None
        self._peers = [mesh.peer(axis, j) for j in range(self.N)] if mesh is not None else None
        self._meta = None
        self._tick = -1
        self._metrics = None
        self._tracer = None
        #: every fault seen: (host, decode tick at detection)
        self.faults: list[tuple[int, int]] = []
        self.recoveries = 0
        self.requests_recovered = 0
        self.recovery_us: list[float] = []
        self.snapshots = 0

    # -- engine plumbing ----------------------------------------------------
    def attach(self, metrics, tracer) -> None:
        """A ``repro_torch.obs`` MetricsRegistry and Tracer (either None)."""
        self._metrics, self._tracer = metrics, tracer

    @property
    def alive(self) -> set[int]:
        return self.group.alive

    @property
    def injected_faults(self) -> int:
        """Scheduled kills fired (injector) or external deaths detected."""
        return self.injector.injected if self.injector is not None else len(self.faults)

    def _is_root(self) -> bool:
        return self._mesh is None or dist.get_rank() == self._mesh[1]

    def snapshot(self, cache, state, tick: int) -> None:
        """Encode the decode-path state ((cache, state) pytree → limbs →
        K shards → N coded shards) and hand shard j to host j. Every leaf
        is read by its bytes: bf16 slabs, int32 counters and seeds, the
        bool mask as one byte a flag; a ``DTensor`` leaf by its global
        value. The guard takes the new snapshot's metadata and tick, and the
        hosts their rows, only once the encode has returned: a snapshot that
        raises leaves the last one whole (on a mesh it raises on every
        rank)."""
        whole = (cache, state)
        meta = state_meta(whole)
        if self._ranks is not None:
            mesh, coded = self._mesh, self._encode_on_ranks(whole)
        else:
            mesh = mesh_group(whole)
            if mesh is None:
                coded = self._encode(whole)
            else:
                group, root = mesh
                whole = gather_state(whole, keep=dist.get_rank() == root)
                coded = on_root(lambda: self._encode(whole), group, root, what="the coded snapshot")
        self._mesh, self._meta, self._tick = mesh, meta, tick
        if coded is not None:
            self.group.store(coded)
        self.snapshots += 1
        if self._metrics is not None:
            self._metrics.counter("serve.snapshots").inc()

    def _encode(self, whole) -> np.ndarray:
        """The N coded rows of a whole plain state, as a host array."""
        if self._collective is None:
            encode = functools.partial(lcc_encode, self.plan)
        else:  # the round schedule runs over all N hosts: pad to N rows
            encode = lambda x: self._collective(lcc_pad(self.plan, x))  # noqa: E731
        return encode_state(whole, self.K, self.device, encode, keep_limbs=False, rows=self.plan.N)[1]

    def _encode_on_ranks(self, whole):
        """This rank's row encoded on the ranks; the N coded rows gathered
        (on the host) to the axis's first rank, which gets them as an
        (N, S) numpy array; ``None`` on every other rank."""
        group, root = self._mesh
        row = state_limb_row(whole, self.K, self._host, self.device)
        out = self._ranks(row[None])[0]
        host = out.cpu() if out.is_cuda else out.contiguous()
        rows = [torch.empty_like(host) for _ in range(dist.get_world_size(group))] if self._is_root() else None
        dist.gather(host, rows, dst=root, group=group)
        if rows is None:
            return None
        # the gather lands in the group's rank order: host j's row at its peer's group rank
        members = [dist.get_global_rank(group, i) for i in range(dist.get_world_size(group))]
        return np.stack([to_numpy(rows[members.index(r)]) for r in self._peers])

    def poll(self, now_tick: int) -> list[int]:
        """Fire due injector kills (SIGKILL when hosts are processes) and
        detect externally dead hosts; returns hosts lost this chunk. On a
        mesh the first rank decides and every rank gets its answer."""
        dead = []
        if self.injector is not None:
            for _t, h in self.injector.due(now_tick):
                if self._is_root() and self.group.kill(h):
                    dead.append(h)
        if self._is_root():
            dead.extend(self.group.scan())
        if self._mesh is not None:
            group, root = self._mesh
            told = torch.full((self.N + 1,), -1, dtype=torch.int64)
            told[0] = len(dead)
            told[1 : 1 + len(dead)] = torch.tensor(dead, dtype=torch.int64)
            dist.broadcast(told, src=root, group=group)
            dead = told[1 : 1 + int(told[0])].tolist()
            self.group.alive.difference_update(dead)
        for h in dead:
            self.faults.append((h, now_tick))
        return dead

    def recover(self, dead: list[int], requests_in_flight: int = 0):
        """Rebuild the chunk-start (cache, state) bit-exactly from any K
        surviving coded shards (Lagrange interpolation), on the guard's
        device. Raises RuntimeError once fewer than K shards survive —
        beyond the code's tolerance. On a mesh every rank calls it and gets
        the whole state, rebuilt on the first rank."""
        if self._meta is None:
            raise RuntimeError("no snapshot taken before recovery")
        span = (
            self._tracer.span(
                "serve.recovery", hosts=str(sorted(dead)), tick=self._tick
            )
            if self._tracer is not None
            else contextlib.nullcontext()
        )
        with span:
            t0 = time.perf_counter()
            if self._mesh is None:
                cache, state = self._rebuild()
            else:
                group, root = self._mesh
                cache, state = broadcast_state(on_root(self._rebuild, group, root), self._meta, group, root,
                                               self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dur_us = (time.perf_counter() - t0) * 1e6
        self.recoveries += len(dead)
        self.requests_recovered += requests_in_flight
        self.recovery_us.append(dur_us)
        if self._metrics is not None:
            self._metrics.counter("serve.recoveries").inc(len(dead))
            self._metrics.histogram("serve.recovery_us").observe(dur_us)
        return cache, state

    def _rebuild(self):
        X = self.group.reconstruct()
        return unshard_state_limbs(to_tensor(X, self.device), self._meta)

    def stats(self) -> dict:
        """JSON-ready recovery block for the benchmark record."""
        us = sorted(self.recovery_us)
        return {
            "K": self.K,
            "R": self.R,
            "n_hosts": self.N,
            "injected_faults": self.injected_faults,
            "recoveries": self.recoveries,
            "requests_recovered": self.requests_recovered,
            "snapshots": self.snapshots,
            "recovery_us": {
                "p50": float(np.percentile(us, 50)) if us else 0.0,
                "p99": float(np.percentile(us, 99)) if us else 0.0,
            },
        }
