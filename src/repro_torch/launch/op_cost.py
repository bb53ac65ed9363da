"""Op-level cost model over ``meta`` tensors (``launch/roofline.py``'s input):
the port's counterpart of the reference's ``launch/jaxpr_cost.py``.

The reference walks a closed jaxpr, where a ``scan`` carries its trip count.
Eager PyTorch dispatches every step of a Python loop, so here a
``TorchDispatchMode`` sees every aten op the function runs, in order, and a
loop's count is simply its steps. Run the function on ``meta`` tensors
(shapes and dtypes, no storage) and nothing is computed. Per op:

* flops: 2·MACs for products (``mm``, ``bmm``, ``addmm``, ``baddbmm`` and
  every other op ``torch.utils.flop_counter`` has a formula for; ``matmul``
  and ``einsum`` reach the dispatcher as these); |out| for elementwise
  arithmetic; 0 for layout, view, dtype-cast and factory ops.
* bytes: inputs + outputs of products and of the "heavy" ops (gather,
  scatter, index, sort, topk, cumulative ops, reductions, cat, pad, arange)
  at full weight; elementwise traffic at 1/``FUSION_DISCOUNT`` (the
  reference's stand-in for fusion).
* ``tile_bytes``: the share of those bytes that belongs to attention score
  tiles, rank ≥ 4 with both trailing dims ≥ 256 (the reference's rule).

Backward and ``torch.utils.checkpoint`` recompute are counted when the
function calls ``torch.autograd.grad`` or ``.backward()`` under the mode.

The same mode tracks live bytes: a storage's bytes are added when an op
creates it (or when it is an argument) and taken off when it is freed (a
finalizer on the untyped storage). The peak is the port's counterpart of the
XLA compiler's ``memory_analysis`` (argument + temp + output bytes).

Ops with no meta kernel whose output size depends on the data
(``bincount``) get the size these inputs need, never the most they could.
"""

from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten
from torch.utils.flop_counter import flop_registry


FUSION_DISCOUNT = 4.0

# layout, view, cast and factory ops: 0 flops, 0 bytes (the reference's _MOVE_OPS)
_MOVE_OPS = {
    "_to_copy", "clone", "_unsafe_view", "view", "reshape", "_reshape_alias", "expand", "t", "transpose",
    "permute", "squeeze", "unsqueeze", "slice", "select", "alias", "detach", "lift_fresh", "flip",
    "as_strided", "unfold", "split", "split_with_sizes", "unbind", "view_as_real", "view_as_complex",
    "repeat", "repeat_interleave", "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "new_zeros", "ones", "ones_like", "new_ones", "full", "full_like", "new_full",
    "scalar_tensor", "fill", "zero", "_local_scalar_dense", "lift_fresh_copy", "_unsafe_index",
    "resize", "set_",
}
# gathers, scatters, sorts, cumulative ops, reductions, concatenation, pad,
# arange: inputs + outputs at full weight (the reference's _HEAVY_OPS)
_HEAVY_OPS = {
    "index", "index_select", "gather", "embedding", "embedding_dense_backward", "index_put", "_index_put_impl",
    "index_add", "index_copy", "scatter", "scatter_add", "scatter_reduce", "slice_scatter", "select_scatter",
    "copy", "sort", "topk", "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp", "sum", "mean", "amax",
    "amin", "max", "min", "argmax", "argmin", "prod", "any", "all", "logsumexp", "linalg_vector_norm", "norm",
    "var", "var_mean", "std", "cat", "stack", "constant_pad_nd", "pad", "arange", "bincount", "nonzero",
}


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    # bytes of attention score/prob TILES: rank ≥ 4 arrays whose last two
    # dims are both ≥ 256 (e.g. (B, Hkv, G, 1024, 1024) f32). A fused
    # attention kernel keeps them on chip; ``bytes - tile_bytes`` is the
    # flash-fused memory-roofline term.
    tile_bytes: float = 0.0
    by_op: dict = field(default_factory=lambda: defaultdict(float))

    def scaled(self, k: float) -> "Cost":
        c = Cost(self.flops * k, self.bytes * k, self.tile_bytes * k)
        for o, v in self.by_op.items():
            c.by_op[o] = v * k
        return c

    def add(self, other: "Cost"):
        self.flops += other.flops
        self.bytes += other.bytes
        self.tile_bytes += other.tile_bytes
        for o, v in other.by_op.items():
            self.by_op[o] += v

    @property
    def bytes_flash(self) -> float:
        return self.bytes - self.tile_bytes

    @property
    def product_flops(self) -> float:
        """The flops of products alone (the reference's ``by_op["dot_general"]``)."""
        return sum(v for o, v in self.by_op.items() if o in _PRODUCT_NAMES)


_PRODUCT_NAMES = {p.__name__ for p in flop_registry}


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _is_attn_tile(t: torch.Tensor) -> bool:
    """Attention score/prob tile: rank ≥ 4 with both trailing dims ≥ 256."""
    sh = t.shape
    return len(sh) >= 4 and sh[-1] >= 256 and sh[-2] >= 256


def _bincount(args, kwargs):
    """``bincount`` has no meta kernel (its length is max(x) + 1 or
    ``minlength``). The port passes ``minlength`` = the number of bins its
    ids can take, which is the length these inputs need."""
    minlength = kwargs.get("minlength", args[2] if len(args) > 2 else 0)
    weights = kwargs.get("weights", args[1] if len(args) > 1 else None)
    if not minlength:
        raise NotImplementedError("op_cost: bincount on meta tensors needs minlength")
    dtype = torch.int64 if weights is None else weights.dtype
    return torch.empty((minlength,), dtype=dtype, device=args[0].device)


# ops with no meta kernel: packet name → output for these inputs
_NO_META = {"bincount": _bincount}


class OpCounter(TorchDispatchMode):
    """Counts every aten op run under it into ``cost`` and tracks live
    storage bytes (``live_bytes``, ``peak_bytes``).

    ``scan_steps``: the models' time scans (``models.ssm._scan``) run only
    that many of their steps under this counter and repeat the last output
    for the rest, recording each scan's length in ``scan_lengths``; a count
    is then affine in ``scan_steps`` (``launch.costpass`` extrapolates two)."""

    def __init__(self, scan_steps: int | None = None):
        super().__init__()
        self.cost = Cost()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}
        self.scan_steps = scan_steps
        self.scan_lengths: set[int] = set()
        self.memory: dict = {}
        self._memo: dict = {}

    # -- live bytes ----------------------------------------------------------
    def hold(self, tensors):
        """Count the storages of ``tensors`` as live until they are freed."""
        for t in tensors:
            s = t.untyped_storage()
            key = id(s)
            if key in self._live:
                continue
            n = s.nbytes()
            self._live[key] = n
            self.live_bytes += n
            weakref.finalize(s, self._free, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key: int):
        self.live_bytes -= self._live.pop(key, 0)

    def held(self, tensors) -> int:
        """Bytes of the distinct storages of ``tensors``."""
        seen = {}
        for t in tensors:
            s = t.untyped_storage()
            seen[id(s)] = s.nbytes()
        return sum(seen.values())

    # -- counting ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = _memo_key(func, args, kwargs)
        hit = self._memo.get(key) if key is not None else None
        if hit is not None:
            spec, metas, charge = hit
            out = tree_unflatten([torch.empty_strided(sh, st, dtype=dt, device="meta") for sh, st, dt in metas], spec)
        else:
            special = _NO_META.get(func.overloadpacket.__name__)
            out = special(args, kwargs) if special is not None else func(*args, **kwargs)
            charge = _charge(func, args, kwargs, out)
            if key is not None:
                leaves, spec = tree_flatten(out)
                if all(isinstance(t, torch.Tensor) and t.is_meta for t in leaves):
                    self._memo[key] = (spec, [(t.shape, t.stride(), t.dtype) for t in leaves], charge)
        self.hold(_tensors(out))
        if charge is not None:
            name, fl, io, tile, by = charge
            c = self.cost
            c.flops += fl
            c.bytes += io
            c.tile_bytes += tile
            c.by_op[name] += by
        return out


def _charge(func, args, kwargs, out):
    """(by_op key, flops, bytes, tile bytes, by_op amount) of one op, or
    ``None`` for a layout, view, cast or factory op."""
    name = func.overloadpacket.__name__
    if name in _MOVE_OPS or func.is_view:
        return None
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    io = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
    tile = sum(_nbytes(t) for t in ins + outs if _is_attn_tile(t))
    formula = flop_registry.get(func.overloadpacket)
    if formula is not None:
        fl = float(formula(*args, **kwargs, out_val=out))
        return name, fl, io, tile, fl
    if name in _HEAVY_OPS:
        return name, 0.0, io, tile, io
    sz = float(sum(t.numel() for t in outs))  # elementwise arithmetic
    return "elementwise", sz, io / FUSION_DISCOUNT, tile / FUSION_DISCOUNT, sz


def _arg_key(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype) if x.is_meta else _UNCACHED
    if isinstance(x, (list, tuple)):
        return tuple(map(_arg_key, x))
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype, torch.device, torch.memory_format,
                                   torch.layout)):
        return (type(x), x)
    return _UNCACHED


_UNCACHED = object()


def _memo_key(func, args, kwargs):
    """A key for an op whose outputs are fresh tensors fixed by its inputs'
    shapes, strides and dtypes (no view, no mutation): repeated calls (the
    steps of a loop) then skip the meta kernel. ``None``: not cached."""
    schema = func._schema
    if func.is_view or schema.is_mutable or any(r.alias_info is not None for r in schema.returns):
        return None
    key = (func, _arg_key(args), tuple((k, _arg_key(v)) for k, v in kwargs.items()))
    return None if _has(key, _UNCACHED) else key


def _has(key, marker) -> bool:
    return key is marker or (isinstance(key, tuple) and any(_has(k, marker) for k in key))


def count_fn(fn, *args, scan_steps: int | None = None) -> OpCounter:
    """Run ``fn(*args)`` under an :class:`OpCounter` (pass ``meta`` tensors:
    nothing is computed) and return the counter: its ``cost``, and its
    ``memory``: ``argument_bytes`` (the arguments' storages),
    ``output_bytes`` (the result's storages that are not arguments') and
    ``peak_bytes`` (the most bytes live at once, arguments included). Global
    logical cost: one device runs all of it."""
    counter = OpCounter(scan_steps)
    arg_tensors = _tensors(args)
    counter.hold(arg_tensors)
    argument_bytes = counter.live_bytes
    with counter:
        out = fn(*args)
    arg_ids = {id(t.untyped_storage()) for t in arg_tensors}
    output_bytes = counter.held([t for t in _tensors(out) if id(t.untyped_storage()) not in arg_ids])
    counter.memory = {"argument_bytes": argument_bytes, "output_bytes": output_bytes,
                      "peak_bytes": counter.peak_bytes}
    return counter


def cost_of_fn(fn, *args) -> Cost:
    """Run ``fn`` on ``args`` under the counter and return its cost (global
    logical cost: divide by the device count for per-device roofline terms
    under even sharding)."""
    return count_fn(fn, *args).cost
