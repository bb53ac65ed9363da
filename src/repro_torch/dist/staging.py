"""A process group that stages CUDA tensors through pinned host memory into
gloo: the transport of a mesh of ranks that share one card.

Gloo runs every collective that DTensor issues on CPU tensors, but on CUDA
tensors its ``all_gather_into_tensor`` ends the process (signal 11; torch
2.11 on an NVIDIA H100, ``tools/gloo_cuda_probe.py``), and DTensor's
redistributions gather. NCCL refuses two ranks on one card. So the mesh
runs over this group, registered as the backend ``"port"``
(:func:`register`) for the ``cpu`` and ``cuda`` device types: every
collective and point-to-point call hands CPU tensors to an inner gloo group
as they are, and copies a CUDA tensor into a pinned host buffer first (after
its stream's work), runs gloo on the host buffers and copies the result
back onto the card. An all-reduce is an all-gather and a reduction on the
host, in rank order. The bytes and calls it stages are counted
(:func:`staged_bytes`, :func:`staged_calls`). Each collective completes
before it returns (the work it gives back is done); a send does not wait
for its receiver.

A Python ``ProcessGroup`` stands for the whole group (PyTorch does not
combine it with another device type's backend), hence both device types.
The method names are PyTorch's across versions (``_allgather_base`` and
``all_gather_single`` are one collective).
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

__all__ = ["BACKEND", "register", "staged_bytes", "staged_calls", "reset_counts"]

BACKEND = "port"

_bytes = collections.Counter()
_calls = collections.Counter()


def staged_bytes() -> dict:
    """Bytes staged through host memory by collective since the last reset
    (each direction counted: to the host and back)."""
    return dict(_bytes)


def staged_calls() -> dict:
    """Calls that staged a CUDA tensor, by collective."""
    return dict(_calls)


def reset_counts() -> None:
    _bytes.clear()
    _calls.clear()


class _Done(dist._Work):
    """A work that has completed: the call ran it to its end."""

    def __init__(self, result=None):
        super().__init__()
        self._fut = torch.futures.Future()
        self._fut.set_result(result)

    def wait(self, timeout=None):
        return True

    def is_completed(self):
        return True

    def get_future(self):
        return self._fut


def _op_name(op) -> str:
    return str(getattr(op, "op", op)).rsplit(".", 1)[-1].upper()


_REDUCE = {
    "SUM": lambda a: a.sum(0),
    "MAX": lambda a: a.amax(0),
    "MIN": lambda a: a.amin(0),
    "PRODUCT": lambda a: a.prod(0),
}


class StagedGloo(dist.ProcessGroup):
    """The ``"port"`` backend: gloo on host copies of CUDA tensors."""

    def __init__(self, store, rank: int, size: int, timeout, group_name: str):
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(store, rank, size, timeout)
        self._name = group_name  # the functional collectives find a group by it

    def getBackendName(self):  # noqa: N802 - PyTorch's name
        return BACKEND

    @property
    def name(self):
        return BACKEND

    @property
    def group_name(self):
        return self._name

    # -- staging -------------------------------------------------------------
    def _run(self, what: str, outs: list, ins: list, op):
        """``op(host_outs, host_ins)`` on host copies of CUDA tensors (CPU
        tensors as they are); the outputs copied back where they live."""
        cuda = [t for t in (*outs, *ins) if t.is_cuda]
        if not cuda:
            op(outs, ins).wait()
            return _Done(outs)
        torch.cuda.current_stream(cuda[0].device).synchronize()
        h_ins = [self._host(t, what, copy=True) for t in ins]
        h_outs = []
        for t in outs:
            aliased = next((h for h, i in zip(h_ins, ins) if i is t), None)
            h_outs.append(aliased if aliased is not None else self._host(t, what, copy=False))
        op(h_outs, h_ins).wait()
        for t, h in zip(outs, h_outs):
            if t.is_cuda:
                t.copy_(h, non_blocking=True)
                _bytes[what] += h.numel() * h.element_size()
        _calls[what] += 1
        return _Done(outs)

    @staticmethod
    def _host(t, what, copy: bool):
        if not t.is_cuda:
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        if copy:
            h.copy_(t)
            _bytes[what] += h.numel() * h.element_size()
        return h

    # -- collectives ---------------------------------------------------------
    def allreduce(self, tensors, opts=None):
        """Each rank's tensor gathered (one ``_allgather_base``), then reduced
        on the host in rank order: the same bits on every rank, and one step
        where gloo's own all-reduce takes several (2-4x slower here)."""
        op = (opts if opts is not None else dist.AllreduceOptions()).reduceOp
        reduce = _REDUCE.get(_op_name(op))
        if reduce is None:
            return self._run("all_reduce", tensors, tensors, lambda o, i: self._gloo.allreduce(o, opts))

        def gather_reduce(outs, ins):
            for t in outs:
                flat = t.reshape(-1)
                every = torch.empty(self.size() * flat.numel(), dtype=t.dtype, device=t.device)
                self._gloo._allgather_base(every, flat.contiguous()).wait()
                t.copy_(reduce(every.view(self.size(), -1)).reshape(t.shape))
            return _Done(outs)

        return self._run("all_reduce", tensors, tensors, gather_reduce)

    def broadcast(self, tensors, opts=None):
        opts = opts if opts is not None else dist.BroadcastOptions()
        return self._run("broadcast", tensors, tensors, lambda o, i: self._gloo.broadcast(o, opts))

    def _allgather_base(self, output, input, opts=None):
        return self._run("all_gather_into_tensor", [output], [input],
                         lambda o, i: self._gloo._allgather_base(o[0], i[0]))

    all_gather_single = _allgather_base

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._allgather_base(o, i)
        return _Done(outputs)

    all_gather_single_coalesced = allgather_into_tensor_coalesced

    def _reduce_scatter_base(self, output, input, opts=None):
        opts = opts if opts is not None else dist.ReduceScatterOptions()
        return self._run("reduce_scatter_tensor", [output], [input],
                         lambda o, i: self._gloo._reduce_scatter_base(o[0], i[0], opts))

    reduce_scatter_single = _reduce_scatter_base

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._reduce_scatter_base(o, i, opts)
        return _Done(outputs)

    reduce_scatter_single_coalesced = reduce_scatter_tensor_coalesced

    def alltoall_base(self, output, input, output_split_sizes, input_split_sizes, opts=None):
        opts = opts if opts is not None else dist.AllToAllOptions()
        return self._run("all_to_all_single", [output], [input],
                         lambda o, i: self._gloo.alltoall_base(o[0], i[0], output_split_sizes, input_split_sizes,
                                                               opts))

    def all_to_all_single(self, output, input, output_split_sizes, input_split_sizes, opts=None):
        return self.alltoall_base(output, input, output_split_sizes, input_split_sizes, opts)

    def barrier(self, opts=None):
        self._gloo.barrier().wait()
        return _Done()

    # point-to-point: a send returns at once (a ring of ranks that each send,
    # then receive, must not wait on its send); a receive into a CUDA tensor
    # waits, then copies onto the card
    def send(self, tensors, dst, tag):
        if any(t.is_cuda for t in tensors):
            torch.cuda.current_stream(tensors[0].device).synchronize()
            tensors = [self._host(t, "send", copy=True) for t in tensors]
            _calls["send"] += 1
        return self._gloo.send(tensors, dst, tag)

    def recv(self, tensors, src, tag):
        if not any(t.is_cuda for t in tensors):
            return self._gloo.recv(tensors, src, tag)
        return self._run("recv", tensors, [], lambda o, i: self._gloo.recv(o, src, tag))


def _create(opts, backend_options=None):
    return StagedGloo(opts.store, opts.group_rank, opts.group_size, opts.timeout, opts.group_id)


def register() -> None:
    """Register the ``"port"`` backend for the ``cpu`` and ``cuda`` device
    types (once a process)."""
    if BACKEND.upper() not in dist.Backend._plugins:
        dist.Backend.register_backend(BACKEND, _create, extended_api=True, devices=["cpu", "cuda"])
