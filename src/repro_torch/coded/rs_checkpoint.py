"""Erasure-coded optimizer/parameter state across the data-parallel axis —
the paper's all-to-all encode as the framework's fault-tolerance fast path
(DESIGN §2, §8; Remark 1 of the paper).

Scheme
------
Every DP replica k holds a distinct state shard x_k (ZeRO-style). Every
``coded_every`` steps the replicas run ONE all-to-all encode of the Cauchy
generator A (universal prepare-and-shoot — C1 = ⌈log_{p+1}K⌉ rounds,
C2 = Θ(√K/p) elements, vs Θ(K/p) for the all-gather a naive scheme needs):
replica k ends up holding the parity packet

    P_k = Σ_r x_r · A[r, k]        (in GF(2^31−1), exact)

in spare device memory. Loss of any set F of ≤ K−|F| nodes destroys
{x_k, P_k : k∈F}; the survivors recover every lost x_r bit-exactly by solving
the f×f Cauchy subsystem  Σ_{r∈F} x_r A[r, j] = P_j − Σ_{r∉F} x_r A[r, j]
for any f surviving parity indices j (every square Cauchy submatrix is
invertible).

Bit-exactness over floats: state is bitcast to 16-bit limbs (canonical
elements < 2^16 < q), encoded, and reassembled — no rounding anywhere.

Representation: limbs are ``int32`` bit-pattern tensors (``core.field``)
holding values < 2^16, read from the state's bytes with
``Tensor.view(torch.uint8)`` in little-endian limb order, leaf by leaf in
JAX's pytree order (``repro_torch.tree``), so they equal the reference's
``uint32`` limbs value for value. The encodes run on the device where the
limbs lie; :func:`state_to_limbs` puts them on ``device`` (``None``: the
card). Recovery runs on the host in numpy, as in the reference.

A state on a mesh of ranks (``DTensor`` leaves) is read by its global value:
its limbs and :class:`LimbMeta` are those of the same state whole. Reading a
DTensor leaf gathers it (``full_tensor()``), a collective call that every
rank of its mesh makes in the same order. The guards gather the leaves one at
a time to one rank, which alone builds the limbs (:func:`gather_state`), or
let each rank build one shard row (:func:`state_limb_row`); a rebuilt state
goes back to every rank whole (:func:`broadcast_state`).
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .. import tree
from ..core.field import M31, Field, resolve_device, to_tensor
from ..core.matrices import cauchy_matrix
from ..core.prepare_shoot import encode_universal
from ..core.schedule import counted_c2, plan_prepare_shoot
from ..dist.collectives import hierarchical_encode, multilevel_encode, ps_encode
from ..dist.ranks import hierarchical_encode_ranks, multilevel_encode_ranks, ps_encode_ranks


def as_residues(x) -> torch.Tensor:
    """``x`` as an ``int32`` bit-pattern tensor: a tensor stays on its device,
    anything else (a numpy array) goes to the card."""
    return to_tensor(x, x.device if isinstance(x, torch.Tensor) else None)


# ---------------------------------------------------------------------------
# bitcast <-> limbs
# ---------------------------------------------------------------------------

# the 32-bit type the reference's ``jnp.asarray`` gives a 64-bit one
# (JAX's 64-bit types are off in the reference)
_TO_32_BITS = {np.dtype(a): np.dtype(b) for a, b in (
    (np.int64, np.int32), (np.uint64, np.uint32), (np.float64, np.float32), (np.complex128, np.complex64))}


def leaf_tensor(leaf) -> torch.Tensor:
    """A state leaf as the tensor the coded layer reads. A tensor stays as
    it is; a ``DTensor`` is its full tensor (a collective call over its
    mesh). Anything else (a Python scalar, a numpy array, an object with
    ``__array__``) is read as the reference's ``jnp.asarray`` reads it: a
    64-bit type becomes its 32-bit one (a Python ``int`` an ``int32``, out
    of range raising ``OverflowError``; a ``float`` a ``float32``), and a
    bfloat16 array, which numpy cannot name, moves by its bits."""
    if isinstance(leaf, DTensor):
        return leaf.full_tensor().detach()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    if isinstance(leaf, int) and not isinstance(leaf, (bool, np.generic)):
        arr = np.array(leaf, dtype=np.int32)
    else:
        arr = np.array(leaf)  # a copy: the reference's arrays are read-only
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(_TO_32_BITS.get(arr.dtype, arr.dtype), copy=False))



@dataclass
class LimbMeta:
    treedef: tree.TreeDef
    shapes: list[tuple[int, ...]]
    dtypes: list[torch.dtype]
    sizes_u16: list[int]
    total: int


def _leaf_bytes(arr: torch.Tensor) -> torch.Tensor:
    """One leaf's bytes as a flat ``uint8`` view (a copy only when the leaf
    is not contiguous); a ``bool``'s byte is 0 or 1, read as ``uint8``."""
    return arr.contiguous().reshape(-1).view(torch.uint8)


def _pairs(u8: torch.Tensor) -> torch.Tensor:
    """Bytes in little-endian pairs as ``int32`` limbs where they lie, an odd
    count padded with one zero byte."""
    if u8.numel() % 2:
        u8 = torch.cat([u8, u8.new_zeros(1)])
    return u8[0::2].to(torch.int32) | (u8[1::2].to(torch.int32) << 8)


def _leaf_limbs(arr: torch.Tensor) -> torch.Tensor:
    """One leaf's limbs as an ``int32`` tensor where ``arr`` lies: its bytes
    in little-endian pairs, a ``bool`` read as ``uint8``, an odd byte count
    padded with one zero byte."""
    return _pairs(_leaf_bytes(arr))


def _limb_size(shape, dtype: torch.dtype) -> int:
    return -(-math.prod(shape) * dtype.itemsize // 2)


def state_meta(state) -> LimbMeta:
    """The :class:`LimbMeta` of ``state``'s limbs, read from each leaf's
    shape and type alone (a ``DTensor``'s global ones): nothing is gathered
    or computed, so every rank of a mesh can read it on its own."""
    leaves, treedef = tree.flatten(state)
    shapes, dtypes = [], []
    for leaf in leaves:
        arr = leaf if isinstance(leaf, torch.Tensor) else leaf_tensor(leaf)
        shapes.append(tuple(arr.shape))
        dtypes.append(arr.dtype)
    sizes = [_limb_size(s, d) for s, d in zip(shapes, dtypes)]
    return LimbMeta(treedef, shapes, dtypes, sizes, sum(sizes))


def state_to_limbs(state, device=None) -> tuple[torch.Tensor, LimbMeta]:
    """Pytree → (S,) ``int32`` tensor of 16-bit limbs (canonical mod-q
    elements) on ``device`` (``None``: the card). A leaf that is not a tensor
    is read as the reference reads it (:func:`leaf_tensor`); a ``bool`` leaf
    is read as ``uint8`` and an odd byte count is padded with one zero
    byte."""
    dev = resolve_device(device)
    leaves, treedef = tree.flatten(state)
    parts = []
    shapes, dtypes, sizes = [], [], []
    for leaf in leaves:
        arr = leaf_tensor(leaf).to(dev)
        shapes.append(tuple(arr.shape))
        dtypes.append(arr.dtype)
        u16 = _leaf_limbs(arr)
        sizes.append(int(u16.numel()))
        parts.append(u16)
    limbs = torch.cat(parts) if parts else torch.zeros((0,), dtype=torch.int32, device=dev)
    return limbs, LimbMeta(treedef, shapes, dtypes, sizes, int(limbs.numel()))


def limbs_to_state(limbs, meta: LimbMeta):
    """The pytree back from its limbs, on the device where ``limbs`` lie."""
    limbs = as_residues(limbs)
    out = []
    off = 0
    for shape, dtype, size in zip(meta.shapes, meta.dtypes, meta.sizes_u16):
        u16 = limbs[off : off + size]
        off += size
        u8 = torch.stack([u16 & 0xFF, (u16 >> 8) & 0xFF], dim=1).reshape(-1).to(torch.uint8)
        u8 = u8[: math.prod(shape) * dtype.itemsize]
        if dtype == torch.bool:
            arr = u8.to(torch.bool).reshape(shape)
        else:
            arr = u8.view(dtype).reshape(shape)
        out.append(arr)
    return tree.unflatten(meta.treedef, out)


# ---------------------------------------------------------------------------
# parity plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParityPlan:
    K: int
    p: int
    q: int
    A: np.ndarray  # (K, K) Cauchy generator
    ps_plan: Any

    @property
    def c1(self) -> int:
        return self.ps_plan.c1

    @property
    def c2(self) -> int:
        return counted_c2(self.ps_plan)


def build_parity_plan(K: int, p: int = 1, q: int = M31) -> ParityPlan:
    f = Field(q)
    A = cauchy_matrix(f, K)
    return ParityPlan(K=K, p=p, q=q, A=A, ps_plan=plan_prepare_shoot(K, p))


# ---------------------------------------------------------------------------
# encodes in column blocks
# ---------------------------------------------------------------------------

#: Device bytes of one block's working set in a blocked encode
#: (:func:`encode_blocks`). Every coded column depends on the same column of
#: the input alone, so an encode run block by block gives the same result,
#: bit for bit, and needs one block's working set beside its input and
#: output instead of many times the whole input.
BLOCK_BYTES = 1 << 30

#: The most working-set bytes an encode of the port takes a column for each
#: row it holds: 53-86 on the H100, 75-88 in the plain path (K = 8 to 48;
#: ``tools/coded_snapshot_memory.py``, ``launch.op_cost.count_fn``).
ROW_BYTES = 96


def block_columns(rows: int) -> int:
    """Columns of one block of an encode that holds ``rows`` rows (the more
    of its input's and its output's): ``BLOCK_BYTES`` over ``rows`` ×
    ``ROW_BYTES``, a multiple of 4, so that only the last block is
    ragged."""
    return max(4, BLOCK_BYTES // (max(rows, 1) * ROW_BYTES) // 4 * 4)


def column_blocks(S: int, rows: int) -> list[tuple[int, int]]:
    """``(lo, hi)`` of each column block of an S-column encode that holds
    ``rows`` rows (one empty block when S is 0)."""
    w = block_columns(rows)
    return [(lo, min(lo + w, S)) for lo in range(0, S, w)] or [(0, 0)]


def encode_blocks(encode, S: int, rows: int, read, sink) -> None:
    """Run ``encode`` (holding ``rows`` rows) over the column blocks of an
    S-column input: for each block ``[lo, hi)``, ``x = read(lo, hi)`` (its
    input, its rows × (hi - lo)) and ``sink(lo, hi, x, encode(x))``, which
    puts the block where it belongs. Nothing of a block outlives its turn
    unless ``sink`` keeps it."""
    for lo, hi in column_blocks(S, rows):
        x = read(lo, hi)
        sink(lo, hi, x, encode(x))
        del x


def encode_columns(encode, x: torch.Tensor, n_out: int | None = None) -> torch.Tensor:
    """``encode(x)`` for an ``(n, *payload)`` tensor with an ``(n_out,
    *payload)`` result (``n_out``: n when ``None``), run over column blocks
    of its flattened payload (of an encode that holds max(n, n_out) rows),
    every block written into one output allocated once where ``x`` lies.
    ``encode(block, out)`` gets each block as a view of ``x`` (its rows lie a
    whole row of ``x`` apart; nothing copies it first) and ``out``, the
    block's columns of the output (its rows a whole output row apart), and
    writes its result there; a result it returns that is not ``out`` is
    stored into it. An input of one block is encoded as it is, with ``out``
    ``None``."""
    flat = x.reshape(x.shape[0], -1)
    S = flat.shape[1]
    n_out = flat.shape[0] if n_out is None else n_out
    blocks = column_blocks(S, max(flat.shape[0], n_out))
    if len(blocks) == 1:
        return encode(x, None)
    out = flat.new_empty((n_out, S))
    for lo, hi in blocks:
        dst = out[:, lo:hi]
        y = encode(flat[:, lo:hi], dst)
        if y is not dst:
            dst.copy_(y)
        del y  # not held through the next block's encode
    return out.reshape((n_out,) + tuple(x.shape[1:]))


class BlockedEncode:
    """An executor's ``(n, *payload)`` callable (``dist.collectives``) run
    over column blocks (:func:`encode_columns`); its attributes (``ir``,
    ``device``, ``kernels``, ``permutes_run``, ...) are the executor's. Each
    block's result is stored into its columns of the output: no step of the
    executor writes into a tensor that exists before it (what keeps its
    overlap stream safe, ``dist.collectives.ir_encode``)."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, x):
        return encode_columns(lambda block, _out: self.fn(block), to_tensor(x, self.fn.device))

    def __getattr__(self, name):
        if name == "fn":
            raise AttributeError(name)
        return getattr(self.fn, name)


class LimbSource:
    """The limbs of a state, read range by range from its leaves without
    building them whole: ``read(a, b)`` is ``state_to_limbs(state)[0][a:b]``
    (zeros past the last limb) on ``device``. Each leaf is read by its bytes
    where it lies and only the bytes of a range move; a leaf that is not a
    tensor is read as the reference reads it (:func:`leaf_tensor`), a
    ``DTensor`` leaf by its full tensor (a collective call, made for every
    leaf). With ``span=(a, b)`` only the leaves that overlap limbs ``[a, b)``
    are kept, and only they can be read."""

    def __init__(self, state, device, span: tuple[int, int] | None = None):
        self.device = resolve_device(device)
        self.starts = [0]
        for size in state_meta(state).sizes_u16:
            self.starts.append(self.starts[-1] + size)
        self.total = self.starts[-1]
        self.leaves = []
        for i, leaf in enumerate(tree.leaves(state)):
            u8 = _leaf_bytes(leaf_tensor(leaf))
            keep = span is None or (self.starts[i] < span[1] and span[0] < self.starts[i + 1])
            self.leaves.append(u8 if keep else None)

    def read(self, a: int, b: int, out: torch.Tensor | None = None) -> torch.Tensor:
        """Limbs ``[a, b)`` into ``out`` ((b - a,) ``int32``, zeros where no
        leaf lies; a new tensor when ``None``)."""
        if out is None:
            out = torch.zeros((b - a,), dtype=torch.int32, device=self.device)
        i = max(bisect.bisect_right(self.starts, a) - 1, 0)
        while i < len(self.leaves) and self.starts[i] < b:
            lo, hi = max(a, self.starts[i]), min(b, self.starts[i + 1])
            if lo < hi:
                off = self.starts[i]
                out[lo - a : hi - a] = _pairs(self.leaves[i][2 * (lo - off) : 2 * (hi - off)].to(self.device))
            i += 1
        return out

    def block(self, K: int, S: int, lo: int, hi: int) -> torch.Tensor:
        """Columns ``[lo, hi)`` of ``shard_state_limbs(state, K)[0]``: a
        ``(K, hi - lo)`` ``int32`` tensor on the device."""
        x = torch.zeros((K, hi - lo), dtype=torch.int32, device=self.device)
        for j in range(K):
            self.read(j * S + lo, j * S + hi, x[j])
        return x


class HostRows:
    """Copies of blocks of ``int32`` device tensors into columns of host
    ``uint32`` arrays. From a CUDA tensor a block goes through one pinned
    staging buffer, allocated at the first copy and reused; into the array's
    columns it is copied by PyTorch's threads (the array is written here
    first, so its pages fault in across them)."""

    def __init__(self):
        self._stage = None

    def put(self, t: torch.Tensor, dst: np.ndarray) -> None:
        """``dst[...] = t`` (bit patterns as ``uint32``)."""
        if t.is_cuda:
            if self._stage is None or self._stage.numel() < t.numel():
                self._stage = torch.empty(t.numel(), dtype=torch.int32, pin_memory=True)
            stage = self._stage[: t.numel()].view(t.shape)
            stage.copy_(t)
            t = stage
        torch.from_numpy(dst.view(np.int32)).copy_(t)


def encode_state(state, K: int, device, encode, keep_limbs: bool,
                 rows: int | None = None) -> tuple[np.ndarray | None, np.ndarray, LimbMeta]:
    """A state's K limb shards (``shard_state_limbs(state, K)``) encoded
    block by block on ``device`` into host arrays: ``(shards or None,
    coded, meta)``. For each column block (of an encode that holds ``rows``
    rows, K when ``None``) the limbs of its K rows are read from the leaves
    that overlap it (:class:`LimbSource`) and encoded (``encode``: (K, w) →
    (n, w)); the block's limbs (with ``keep_limbs``)
    and its coded rows are copied into ``uint32`` host arrays of S columns.
    Neither the whole limbs nor the whole coded rows ever lie on the
    device."""
    meta = state_meta(state)
    src = LimbSource(state, device)
    S = -(-meta.total // K)
    shards = np.empty((K, S), dtype=np.uint32) if keep_limbs else None
    coded = []
    host = HostRows()

    def sink(lo, hi, x, y):
        if not coded:
            coded.append(np.empty((y.shape[0], S), dtype=np.uint32))
        if keep_limbs:
            host.put(x, shards[:, lo:hi])
        host.put(y, coded[0][:, lo:hi])

    encode_blocks(encode, S, K if rows is None else rows, lambda lo, hi: src.block(K, S, lo, hi), sink)
    return shards, coded[0], meta


def encode_parity(x_limbs, plan: ParityPlan) -> torch.Tensor:
    """Single-program path: x_limbs (K, S) → (K, S) parity packets, via the
    universal algorithm (host-A Shoup path), on the device where the limbs
    lie (a numpy array goes to the card), over column blocks
    (:func:`encode_columns`), each block's last shoot round summing into its
    columns of the output."""
    return encode_columns(lambda x, out: encode_universal(x, plan.A, p=plan.p, q=plan.q, plan=plan.ps_plan, out=out),
                          as_residues(x_limbs))


def encode_parity_collective(plan: ParityPlan, sizes=None, *, device=None):
    """The IR path: returns a (K, S) → (K, S) callable that runs the parity
    encode as the compiled round schedule of ``dist.collectives`` on one
    device (``None``: the card), the K replicas being the tensor's first
    axis.

    ``sizes`` stands where the reference's mesh axes stand, outermost →
    innermost: ``None`` or one size is the flat prepare-and-shoot
    (``ps_encode``), two sizes the two-level ``hierarchical_encode`` with
    ``k_intra = sizes[1]``, more the recursive ``multilevel_encode``. Every
    variant is bit-exact (same modular sums, reassociated). The multi-rank
    form, one replica a rank, is :func:`encode_parity_ranks`. The callable
    runs the schedule over column blocks (:class:`BlockedEncode`)."""
    sizes = (plan.K,) if sizes is None else tuple(int(s) for s in sizes)
    if math.prod(sizes) != plan.K:
        raise ValueError(f"sizes {sizes} hold {math.prod(sizes)} replicas, the plan has K={plan.K}")
    kw = dict(p=plan.p, q=plan.q, device=device)
    if len(sizes) == 1:
        fn, _ = ps_encode(plan.A, **kw)
    elif len(sizes) == 2:
        fn, _ = hierarchical_encode(plan.A, k_intra=sizes[1], **kw)
    else:
        fn, _ = multilevel_encode(plan.A, sizes, **kw)
    return BlockedEncode(fn)


def encode_parity_ranks(mesh, axes, plan: ParityPlan):
    """The mesh path, one replica a rank (``repro_torch.dist.ranks``): a
    callable mapping this rank's ``(1, S)`` limbs to its ``(1, S)`` parity
    packet, the reference's ``encode_parity_collective(mesh, axis, plan)``.
    ``axes`` is one axis name (flat prepare-and-shoot) or a tuple of them
    outermost → innermost: one is flat, two the two-level
    ``hierarchical_encode_ranks``, more the recursive
    ``multilevel_encode_ranks``."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    kw = dict(p=plan.p, q=plan.q)
    if len(axes) == 1:
        fn, _ = ps_encode_ranks(mesh, axes[0], plan.A, **kw)
    elif len(axes) == 2:
        fn, _ = hierarchical_encode_ranks(mesh, axes[0], axes[1], plan.A, **kw)
    else:
        fn, _ = multilevel_encode_ranks(mesh, axes, plan.A, **kw)
    return fn


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------


def recover_lost(
    plan: ParityPlan,
    lost: list[int],
    surviving_x: dict[int, np.ndarray],
    surviving_parity: dict[int, np.ndarray],
) -> dict[int, np.ndarray]:
    """Recover the lost replicas' limb arrays bit-exactly, on the host.

    surviving_x/parity: {replica index → (S,) numpy limbs}. Needs
    |surviving_parity| ≥ |lost| (any subset works — Cauchy guarantee).
    """
    f = Field(plan.q)
    F = sorted(lost)
    J = sorted(surviving_parity)[: len(F)]
    if len(J) < len(F):
        raise ValueError(f"need ≥{len(F)} surviving parity shards, have {len(J)}")
    A = plan.A
    S = next(iter(surviving_parity.values())).shape[0]
    rhs = np.zeros((len(J), S), dtype=np.uint64)
    for ji, j in enumerate(J):
        acc = surviving_parity[j].astype(np.uint64) % f.q
        for r, xr in surviving_x.items():
            acc = f.sub(acc, f.mul(xr, A[r, j]))
        rhs[ji] = acc
    M = A[np.ix_(F, J)].T.astype(np.uint64)  # equations j × unknowns r
    sol = f.solve(M, rhs)  # (f, S)
    return {r: sol[i] for i, r in enumerate(F)}


# ---------------------------------------------------------------------------
# high-level: coded checkpoint of a training-state pytree across K replicas
# ---------------------------------------------------------------------------


def shard_state_limbs(state, K: int, device=None) -> tuple[torch.Tensor, LimbMeta]:
    """Flatten state to limbs on ``device`` (``None``: the card) and split
    them into K equal shards (zero-padded to a multiple of K)."""
    limbs, meta = state_to_limbs(state, device)
    S = -(-int(limbs.numel()) // K)
    pad = S * K - limbs.numel()
    if pad:
        limbs = torch.cat([limbs, limbs.new_zeros(pad)])
    return limbs.reshape(K, S), meta


def unshard_state_limbs(shards, meta: LimbMeta):
    return limbs_to_state(as_residues(shards).reshape(-1)[: meta.total], meta)


# ---------------------------------------------------------------------------
# a state on a mesh of ranks
# ---------------------------------------------------------------------------


def mesh_group(state):
    """``(group, root)`` of a state on a mesh of ranks: the process group
    over every rank of its ``DTensor`` leaves' mesh and the global rank that
    gathers and encodes (the mesh's first); ``None`` for a state with no
    ``DTensor`` leaf. A mesh of more than one axis must span the whole
    world."""
    dm = next((leaf.device_mesh for leaf in tree.leaves(state) if isinstance(leaf, DTensor)), None)
    if dm is None:
        return None
    ranks = sorted(int(r) for r in dm.mesh.flatten().tolist())
    if dm.ndim == 1:
        return dm.get_group(0), ranks[0]
    if ranks != list(range(dist.get_world_size())):
        raise ValueError(f"a state on a mesh of ranks {ranks} that is not the whole world "
                         f"of {dist.get_world_size()} ranks")
    return dist.group.WORLD, ranks[0]


def gather_state(state, keep: bool):
    """``state`` whole, every ``DTensor`` leaf by its full tensor, gathered
    one leaf at a time: a collective call that every rank of the mesh makes.
    A rank with ``keep`` false drops each gathered leaf at once and gets
    ``None``."""
    leaves, treedef = tree.flatten(state)
    out = []
    for leaf in leaves:
        t = leaf_tensor(leaf)
        if keep:
            out.append(t)
    return tree.unflatten(treedef, out) if keep else None


def state_limb_row(state, K: int, j: int, device=None) -> torch.Tensor:
    """Row ``j`` of ``shard_state_limbs(state, K)[0]`` ((S,) ``int32`` on
    ``device``), read from the leaves that overlap it (:class:`LimbSource`);
    a row past the K-th is zeros (the LCC padding). Every ``DTensor`` leaf is
    gathered, so every rank of the mesh calls it, each for its own row."""
    S = -(-state_meta(state).total // K)
    span = (j * S, (j + 1) * S)
    return LimbSource(state, device, span).read(*span)


def on_root(fn, group, root: int, what: str = "the coded state's recovery"):
    """``fn()`` on the rank ``root`` of ``group`` alone, its outcome told to
    every rank (a collective call): root gets what ``fn`` returned and
    every other rank ``None``; when ``fn`` raises, root raises its error and
    every other rank a ``RuntimeError`` saying that ``what`` failed on
    root."""
    out, err = None, None
    if dist.get_rank() == root:
        try:
            out = fn()
        except Exception as e:  # told to every rank, then raised
            err = e
    failed = torch.tensor([int(err is not None)], dtype=torch.int64)
    dist.broadcast(failed, src=root, group=group)
    if err is not None:
        raise err
    if int(failed[0]):
        raise RuntimeError(f"{what} failed on rank {root}")
    return out


def broadcast_state(state, meta: LimbMeta, group, root: int, device=None):
    """The whole plain state on every rank of ``group``: ``root`` sends its
    ``state`` leaf by leaf (by its bytes, from host memory: a gloo group
    takes no CUDA tensor), every other rank passes ``None`` and receives
    into tensors of ``meta``'s shapes and types on ``device`` (``None``: the
    card)."""
    dev = resolve_device(device)
    mine = tree.leaves(state) if state is not None else None
    out = []
    for i, (shape, dtype) in enumerate(zip(meta.shapes, meta.dtypes)):
        t = mine[i].to(dev).contiguous() if mine is not None else torch.empty(shape, dtype=dtype, device=dev)
        raw = t.reshape(-1).view(torch.uint8)
        host = raw.cpu() if raw.is_cuda else raw
        dist.broadcast(host, src=root, group=group)
        if raw.is_cuda:
            raw.copy_(host)
        out.append(t)
    return tree.unflatten(meta.treedef, out)
