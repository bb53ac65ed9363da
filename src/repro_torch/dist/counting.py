"""The dry run's collectives: a process group that sends nothing, and a
dispatch mode that counts every collective a rank issues — the port's
counterpart of the reference's 512 forced host devices and its
``parse_collectives``.

**A world of any size in one process.** :func:`fake_world` joins the default
group over the ``"dryrun"`` backend (:func:`register`) as rank 0 of ``n``:
a Python ``ProcessGroup`` (:class:`NullGroup`) whose every collective and
point-to-point call completes at once and moves nothing. A ``DeviceMesh``
over it (``launch.mesh.make_mesh(..., device="meta")``) carries DTensors
whose local blocks are ``meta`` tensors: a step runs its sharding
propagation and its regions on shapes alone, and nothing is allocated. Only one default group fits in a process, so a world of another
size needs a process of its own.

**What is counted, and where.** :class:`CollectiveCounter` is a
``TorchDispatchMode`` (an ``op_cost.OpCounter``: it also tracks the live
bytes of the local blocks and cuts the models' time scans). It lets DTensor
dispatch first (as ``CommDebugMode`` does) and so sees the collectives
DTensor's redistributions issue as ``_c10d_functional`` ops (and its
shard-to-shard ``_dtensor.shard_dim_alltoall`` on a mesh of cards), on ``meta``
tensors too (whose meta kernels never reach a group), and the legacy
``c10d`` ops a C++ group (gloo) issues for ``torch.distributed.all_reduce``
and the like. A Python group (this one, or the staging group of
``dist/staging.py``) is called by ``torch.distributed.all_reduce``
directly, with no dispatcher op; :class:`NullGroup` reports those calls to
the active counter itself. So the count is the same on the fake world and
on a real gloo world (``tests/test_torch_dryrun_mesh.py`` holds it), and a
region's own ``all_reduce`` (``dist._compat.all_reduce``) is counted on both.

Each call is recorded by this rank under the name the staging group gives
it (``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``, ``broadcast``, ``send``, ``recv``; a coalesced call
is one call a tensor, as staging runs it), with its count and its input
and output bytes (:attr:`CollectiveCounter.calls`).

**Bytes.** :meth:`CollectiveCounter.collectives` gives the reference's
record: op → ``count`` and ``bytes``, where ``bytes`` is the output bytes a
device (the reference's ``parse_collectives`` reads the output shape of each
collective in the per-device HLO), under the reference's names
(:data:`OP_NAMES`). A permute is counted where it is received (a ``recv``);
a ``send`` has no output and adds nothing there. The staging group counts
the bytes it copies through host memory, each direction once: a call's
input (a copy in; an all-reduce is in place and staged as an all-gather and
a host sum, so its input is its output) and its output (a copy back). So a
staged call's bytes are its input plus its output bytes:
:meth:`CollectiveCounter.staged_bytes`.
"""

from __future__ import annotations

import collections
import datetime

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from ..launch.op_cost import OpCounter, _tensors
from .staging import _Done

__all__ = ["BACKEND", "OP_NAMES", "register", "fake_world", "NullGroup", "CollectiveCounter", "collectives_of",
           "count_collectives"]

BACKEND = "dryrun"

#: the staging group's name of a call → the reference's op (``None``: not in
#: the op table)
OP_NAMES = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "recv": "collective-permute",
    "broadcast": "broadcast",
    "send": None,
}

_FUNCTIONAL = ("_c10d_functional", "_c10d_functional_autograd", "c10d_functional")
_NOT_COLLECTIVE = {"wait_tensor", "_wrap_tensor_autograd", "barrier", "monitored_barrier_"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _calls_of(ns: str, name: str, args, out) -> list[tuple[str, int, int]]:
    """(staging name, input bytes, output bytes) of each call in one
    dispatcher op, from its arguments and result."""
    if ns == "_dtensor" and name == "shard_dim_alltoall":  # DTensor's shard-to-shard step on a card
        return [("all_to_all_single", _nbytes(args[0]), _nbytes(out))]
    if ns in _FUNCTIONAL:
        base = name.rstrip("_")
        ins = _tensors(args[0])
        outs = _tensors(out) if not name.endswith("_") else ins
        for raw in ("all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor", "all_to_all_single",
                    "broadcast"):
            if base == raw or base == raw + "_coalesced" or base == raw + "_out":
                return [(raw, _nbytes(i), _nbytes(o)) for i, o in zip(ins, outs, strict=True)]
    else:  # c10d: the ops a C++ group (gloo) runs
        if name in ("allreduce_", "allreduce_coalesced_", "broadcast_"):
            raw = "broadcast" if name == "broadcast_" else "all_reduce"
            return [(raw, _nbytes(t), _nbytes(t)) for t in args[0]]
        if name == "_allgather_base_":
            return [("all_gather_into_tensor", _nbytes(args[1]), _nbytes(args[0]))]
        if name == "allgather_into_tensor_coalesced_":
            return [("all_gather_into_tensor", _nbytes(i), _nbytes(o)) for o, i in zip(args[0], args[1])]
        if name == "_reduce_scatter_base_":
            return [("reduce_scatter_tensor", _nbytes(args[1]), _nbytes(args[0]))]
        if name == "reduce_scatter_tensor_coalesced_":
            return [("reduce_scatter_tensor", _nbytes(i), _nbytes(o)) for o, i in zip(args[0], args[1])]
        if name == "alltoall_base_":
            return [("all_to_all_single", _nbytes(args[1]), _nbytes(args[0]))]
        if name == "send":
            return [("send", _nbytes(t), 0) for t in args[0]]
        if name in ("recv_", "recv_any_source_"):
            return [("recv", 0, _nbytes(t)) for t in args[0]]
    raise NotImplementedError(f"the collective counter has no reading of {ns}.{name}")


class CollectiveCounter(OpCounter):
    """Counts the collectives this rank issues while it is active (see the
    module's docstring), beside :class:`~repro_torch.launch.op_cost.OpCounter`'s
    cost and live bytes of the local blocks (a DTensor op is left to DTensor,
    whose local ops this counter then sees). ``calls``: staging name →
    ``{"count", "input_bytes", "output_bytes"}``."""

    def __init__(self, scan_steps: int | None = None):
        super().__init__(scan_steps)
        self.calls: dict = collections.defaultdict(lambda: {"count": 0, "input_bytes": 0, "output_bytes": 0})

    def record(self, raw: str, input_bytes: int, output_bytes: int) -> None:
        c = self.calls[raw]
        c["count"] += 1
        c["input_bytes"] += input_bytes
        c["output_bytes"] += output_bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor first: its local ops and collectives come back here
        ns = getattr(func, "namespace", None)
        name = func.overloadpacket.__name__ if ns in (*_FUNCTIONAL, "c10d", "_dtensor") else None
        if ns in _FUNCTIONAL or ns == "c10d" or name == "shard_dim_alltoall":
            out = func(*args, **(kwargs or {}))
            if name not in _NOT_COLLECTIVE:
                for call in _calls_of(ns, name, args, out):
                    self.record(*call)
                self.hold(_tensors(out))
            return out
        return super().__torch_dispatch__(func, types, args, kwargs)

    def collectives(self) -> dict:
        """This rank's calls in the reference's record (:func:`collectives_of`)."""
        return collectives_of(self.calls)

    def staged_calls(self) -> dict:
        """Calls by staging name, as ``staging.staged_calls()`` counts them."""
        return {raw: c["count"] for raw, c in sorted(self.calls.items())}

    def staged_bytes(self) -> dict:
        """Bytes by staging name, as ``staging.staged_bytes()`` counts them
        on a card: each call's input and output bytes."""
        return {raw: c["input_bytes"] + c["output_bytes"] for raw, c in sorted(self.calls.items())}


def collectives_of(calls: dict) -> dict:
    """Calls (staging name → ``count``, ``input_bytes``, ``output_bytes``)
    in the reference's record: op → ``{"count", "bytes"}``, ``bytes`` the
    output bytes of this device, ops under the reference's names."""
    out: dict = {}
    for raw, c in sorted(calls.items()):
        op = OP_NAMES[raw]
        if op is not None:
            rec = out.setdefault(op, {"count": 0, "bytes": 0})
            rec["count"] += c["count"]
            rec["bytes"] += c["output_bytes"]
    return out


def _active_counter() -> CollectiveCounter | None:
    """The counter on the dispatch-mode stack: none while a counter runs a
    dispatcher op it has counted already."""
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, CollectiveCounter):
            return mode
    return None


class NullGroup(dist.ProcessGroup):
    """The ``"dryrun"`` backend: every call completes at once and moves
    nothing (outputs keep what they held: on ``meta`` tensors, nothing). A
    call made on it directly (``torch.distributed.all_reduce`` and the like,
    which reach a Python group with no dispatcher op) is reported to the
    active :class:`CollectiveCounter`."""

    def __init__(self, store, rank: int, size: int, timeout, group_name: str):
        super().__init__(rank, size)
        self._name = group_name  # the functional collectives find a group by it

    def getBackendName(self):  # noqa: N802 - PyTorch's name
        return BACKEND

    @property
    def name(self):
        return BACKEND

    @property
    def group_name(self):
        return self._name

    @staticmethod
    def _done(calls, result):
        counter = _active_counter()
        if counter is not None:
            for call in calls:
                counter.record(*call)
        return _Done(result)

    def allreduce(self, tensors, opts=None):
        return self._done([("all_reduce", _nbytes(t), _nbytes(t)) for t in tensors], tensors)

    allreduce_coalesced = allreduce

    def broadcast(self, tensors, opts=None):
        return self._done([("broadcast", _nbytes(t), _nbytes(t)) for t in tensors], tensors)

    def _allgather_base(self, output, input, opts=None):
        return self._done([("all_gather_into_tensor", _nbytes(input), _nbytes(output))], [output])

    all_gather_single = _allgather_base

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        return self._done([("all_gather_into_tensor", _nbytes(i), _nbytes(o)) for o, i in zip(outputs, inputs)],
                          outputs)

    def _reduce_scatter_base(self, output, input, opts=None):
        return self._done([("reduce_scatter_tensor", _nbytes(input), _nbytes(output))], [output])

    reduce_scatter_single = _reduce_scatter_base

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        return self._done([("reduce_scatter_tensor", _nbytes(i), _nbytes(o)) for o, i in zip(outputs, inputs)],
                          outputs)

    def alltoall_base(self, output, input, output_split_sizes, input_split_sizes, opts=None):
        return self._done([("all_to_all_single", _nbytes(input), _nbytes(output))], [output])

    def barrier(self, opts=None):
        return _Done()

    def send(self, tensors, dst, tag):
        return self._done([("send", _nbytes(t), 0) for t in tensors], tensors)

    def recv(self, tensors, src, tag):
        return self._done([("recv", 0, _nbytes(t)) for t in tensors], tensors)


def _create(opts, backend_options=None):
    return NullGroup(opts.store, opts.group_rank, opts.group_size, opts.timeout, opts.group_id)


def register() -> None:
    """Register the ``"dryrun"`` backend (once a process)."""
    if BACKEND.upper() not in dist.Backend._plugins:
        dist.Backend.register_backend(BACKEND, _create, extended_api=True, devices=["cpu", "meta"])


def fake_world(n: int) -> None:
    """Make this process rank 0 of a world of ``n`` ranks over the
    ``"dryrun"`` backend (an in-memory store; no other process joins). A
    process already in such a world of ``n`` ranks stays in it; one in
    another world raises ``RuntimeError``: the count runs in a process of
    its own."""
    if dist.is_initialized():
        if dist.get_backend() != BACKEND or dist.get_world_size() != n:
            raise RuntimeError(f"this process is in a world of {dist.get_world_size()} ranks over "
                               f"{dist.get_backend()!r}; the dry run needs one of {n} over {BACKEND!r} "
                               f"in a process of its own")
        return
    register()
    dist.init_process_group(BACKEND, store=dist.HashStore(), rank=0, world_size=n,
                            timeout=datetime.timedelta(seconds=60))


def count_collectives(fn, *args, scan_steps: int | None = None) -> CollectiveCounter:
    """Run ``fn(*args)`` under a :class:`CollectiveCounter` and return it
    (``memory`` as ``op_cost.count_fn`` gives it, over the local blocks of
    DTensor arguments)."""
    counter = CollectiveCounter(scan_steps)
    local = [t.to_local() if isinstance(t, DTensor) else t for t in _tensors(args)]
    counter.hold(local)
    argument_bytes = counter.live_bytes
    with counter:
        out = fn(*args)
    arg_ids = {id(t.untyped_storage()) for t in local}
    outs = [t.to_local() if isinstance(t, DTensor) else t for t in _tensors(out)]
    counter.memory = {"argument_bytes": argument_bytes,
                      "output_bytes": counter.held([t for t in outs if id(t.untyped_storage()) not in arg_ids]),
                      "peak_bytes": counter.peak_bytes}
    return counter
