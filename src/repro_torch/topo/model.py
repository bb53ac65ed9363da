"""Declarative network topologies + α-β time estimation for round schedules.

The paper's cost model (§I) charges every round β and every element τ on a
flat synchronous p-port network where any processor can reach any other in
one hop. Real fabrics are not flat: a torus has only neighbour links, a
multi-node job adds a slow level on top of the fast links inside a node, and
a ring only has neighbor links. This module describes those networks
declaratively and prices an arbitrary round schedule on them:

* a :class:`Topology` knows its directed links, the deterministic route
  (link sequence) between any two processors, and each link's α/β cost;
* :func:`schedule_time` maps a round schedule — ``list`` of rounds, each a
  ``{(src, dst): elements}`` message map, exactly the shape the cost-exact
  simulator records in ``SimStats.round_messages`` and ``topo.lower``
  produces analytically — onto the topology: every message occupies every
  link of its route, per-link time is serialized (#msgs·α + load·β), and a
  round lasts as long as its busiest link.

On :class:`FullyConnected` this collapses to the paper's model exactly:
``total = C1·α + C2·β·payload`` (each message has a private link).

Paper-notation glossary (used throughout ``repro_torch.topo``):

* ``K``  — number of processors; each holds one packet ``x_k`` and must end
  with ``x̃_k = (x @ A)_k`` (paper §I).
* ``p``  — ports per processor: per round every processor sends ≤ p and
  receives ≤ p messages (the synchronous p-port model).
* ``C1`` — round count of a schedule; ``C2`` — Σ over rounds of the largest
  message (field elements per port) — the paper's two cost coordinates.
* ``α/β`` — per-link startup seconds / seconds per element (Hockney): the
  refinement this module adds on top of the paper's uniform round cost.
* ``I, G`` — the two-level factorization K = I·G (``k_intra`` × ``k_inter``);
  :class:`Hierarchy` generalizes to K = Π_j K_j with level 0 innermost
  (fastest links) and level L−1 outermost (slowest).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LinkCost:
    """Per-link α-β parameters: ``alpha`` seconds of per-message startup,
    ``beta`` seconds per field element crossing the link.

    ``gamma`` is an optional contention-degradation factor: when ``cnt``
    messages share the link in one round, the bandwidth term is inflated to
    ``elems·beta·(1 + gamma·(cnt − 1))`` — serialization overhead (packet
    interleaving, credit stalls) that grows with the number of concurrent
    flows. The default ``gamma = 0`` keeps the purely additive Hockney model,
    under which splitting a round can never strictly win (max is subadditive);
    a fabric with ``gamma > 0`` is what makes ``split_contended`` profitable."""

    alpha: float
    beta: float
    gamma: float = 0.0


# The reference package's model constants, not measured on this card: they
# mirror core.bounds.CostModel (1 µs start-up, one 4-byte element over a
# 50 GB/s link for the fast level ``ICI``; 10 µs and 5 GB/s for the slow level
# ``DCI``) and keep their names, so that both packages price a schedule, decide
# a pass and pick an autotuner candidate alike. Fit your own per-level α/β
# (``calibrate.fit_level_costs``) for any statement about a real fabric.
ICI = LinkCost(alpha=1e-6, beta=4.0 / 50e9)
DCI = LinkCost(alpha=10e-6, beta=4.0 / 5e9)

# Local arithmetic: one modular multiply-accumulate (Shoup mul + add) per
# payload element, 20 ps each (the reference package's model constant, not
# measured on this card). Coefficients
# that are uniformly 0 across processors cost nothing (the lowering drops the
# term) and uniformly-1 coefficients cost only an add (the lowering skips the
# multiply), priced at ADD_WEIGHT of a full MAC. Used by
# ``topo.passes.ir_time`` to price LocalOps and the overlap credit of
# ``pipeline_rounds``.
MAC_SECONDS = 2e-11
ADD_WEIGHT = 0.25


def local_op_unit_work(op) -> float:
    """MAC-equivalents *per payload element* of a ScheduleIR ``LocalOp``.

    With coefficients available this is exact w.r.t. the fused lowering's
    strength reduction: per (out, in) coefficient that is uniform across
    processors, 0 → free, 1 → ``ADD_WEIGHT``, anything else (or non-uniform)
    → one MAC. Structure-only ops (``coeffs=None``) are priced conservatively
    as a dense ``n_out × n_in`` contraction."""
    import numpy as np

    if op.coeffs is None:
        return float(len(op.out_slots) * len(op.in_slots))
    c = np.asarray(op.coeffs)
    ones = np.all(c == 1, axis=0)
    zeros = np.all(c == 0, axis=0)
    general = ~(ones | zeros)
    return float(general.sum()) + ADD_WEIGHT * float(ones.sum())


class Topology:
    """Base class: ``n`` processors, deterministic shortest-path routing.

    Subclasses define :meth:`route` (the ordered directed-link sequence a
    ``src → dst`` message traverses; each link is a hashable id) and
    :meth:`link_cost`.
    """

    n: int
    name: str = "topology"

    def route(self, src: int, dst: int) -> tuple:
        raise NotImplementedError

    def link_cost(self, link) -> LinkCost:
        raise NotImplementedError

    def hops(self, src: int, dst: int) -> int:
        return len(self.route(src, dst))


def _ring_route(n: int, src: int, dst: int, tag):
    """Shorter-direction route on an n-ring; ties go forward. Links are
    ``(tag, u, v)`` with v = u±1 (mod n)."""
    fwd = (dst - src) % n
    links = []
    if fwd <= n - fwd:
        for h in range(fwd):
            u = (src + h) % n
            links.append((tag, u, (u + 1) % n))
    else:
        for h in range(n - fwd):
            u = (src - h) % n
            links.append((tag, u, (u - 1) % n))
    return tuple(links)


@dataclass(frozen=True)
class FullyConnected(Topology):
    """Today's implicit model: a private link per ordered pair — any uniform
    shift is one hop and messages never contend."""

    n: int
    cost: LinkCost = ICI
    name: str = "flat"

    def route(self, src, dst):
        if src == dst:
            return ()
        return (("flat", src, dst),)

    def link_cost(self, link):
        return self.cost


@dataclass(frozen=True)
class Ring(Topology):
    """Bidirectional ring: processor k links only to k±1. A shift-s message
    travels min(s, n−s) hops and contends with everything else crossing the
    same neighbor links."""

    n: int
    cost: LinkCost = ICI
    name: str = "ring"

    def route(self, src, dst):
        if src == dst:
            return ()
        return _ring_route(self.n, src, dst, "ring")

    def link_cost(self, link):
        return self.cost


@dataclass(frozen=True)
class Torus2D(Topology):
    """rows × cols torus with dimension-ordered (row-ring then col-ring)
    routing; processor k = r·cols + c."""

    rows: int
    cols: int
    cost: LinkCost = ICI
    name: str = "torus"

    @property
    def n(self):  # type: ignore[override]
        return self.rows * self.cols

    def route(self, src, dst):
        if src == dst:
            return ()
        sr, sc = divmod(src, self.cols)
        dr, dc = divmod(dst, self.cols)
        links = []
        # move along the row ring (vary column) at row sr, then the column ring
        for tag, u, v in _ring_route(self.cols, sc, dc, "x"):
            links.append(("x", sr, u, v))
        for tag, u, v in _ring_route(self.rows, sr, dr, "y"):
            links.append(("y", dc, u, v))
        return tuple(links)

    def link_cost(self, link):
        return self.cost


@dataclass(frozen=True)
class Torus3D(Topology):
    """depth × rows × cols torus (a 3D mesh with wraparound) with
    dimension-ordered x → y → z routing; processor k = (z·rows + r)·cols + c.
    Links are per-ring, keyed by the fixed coordinates of the ring they sit
    on, so two messages moving along the same physical wire contend."""

    depth: int
    rows: int
    cols: int
    cost: LinkCost = ICI
    name: str = "torus3d"

    @property
    def n(self):  # type: ignore[override]
        return self.depth * self.rows * self.cols

    def coords(self, k: int) -> tuple[int, int, int]:
        zr, c = divmod(k, self.cols)
        z, r = divmod(zr, self.rows)
        return z, r, c

    def route(self, src, dst):
        if src == dst:
            return ()
        sz, sr, sc = self.coords(src)
        dz, dr, dc = self.coords(dst)
        links = []
        # x (column index) at fixed (z=sz, r=sr), then y at (z=sz, c=dc),
        # then z at (r=dr, c=dc) — dimension-ordered, deadlock-free
        for tag, u, v in _ring_route(self.cols, sc, dc, "x"):
            links.append(("x", sz, sr, u, v))
        for tag, u, v in _ring_route(self.rows, sr, dr, "y"):
            links.append(("y", sz, dc, u, v))
        for tag, u, v in _ring_route(self.depth, sz, dz, "z"):
            links.append(("z", dr, dc, u, v))
        return tuple(links)

    def link_cost(self, link):
        return self.cost


@dataclass(frozen=True)
class TwoLevel(Topology):
    """K = K_inter × K_intra two-level hierarchy (multi-slice model):
    processor k = g·K_intra + i sits in group g. Within a group every ordered
    pair has a private fast link (``ICI`` cost); between groups g ≠ g' ALL
    traffic shares one slow trunk per ordered group pair (``DCI`` cost) —
    the contention the hierarchical schedule is designed to avoid."""

    k_intra: int
    k_inter: int
    intra: LinkCost = ICI
    inter: LinkCost = DCI
    name: str = "two-level"

    @property
    def n(self):  # type: ignore[override]
        return self.k_intra * self.k_inter

    def group(self, k: int) -> int:
        return k // self.k_intra

    def route(self, src, dst):
        if src == dst:
            return ()
        gs, gd = self.group(src), self.group(dst)
        if gs == gd:
            return (("intra", src, dst),)
        return (("inter", gs, gd),)

    def link_cost(self, link):
        return self.intra if link[0] == "intra" else self.inter


def default_level_costs(
    n_levels: int, lo: LinkCost = ICI, hi: LinkCost = DCI
) -> tuple[LinkCost, ...]:
    """Per-level α/β defaults for an ``n_levels``-deep :class:`Hierarchy`:
    innermost = ``lo`` (fast), outermost = ``hi`` (slow), intermediate levels
    geometrically interpolated (so a 2-level hierarchy prices exactly like
    TwoLevel and a 3-level chip < slice < pod gets a √(lo·hi) slice tier)."""
    if n_levels <= 1:
        return (lo,) * max(n_levels, 1)
    costs = [lo]
    for j in range(1, n_levels - 1):
        f = j / (n_levels - 1)
        costs.append(
            LinkCost(
                alpha=lo.alpha * (hi.alpha / lo.alpha) ** f,
                beta=lo.beta * (hi.beta / lo.beta) ** f,
            )
        )
    costs.append(hi)
    return tuple(costs)


@dataclass(frozen=True)
class Hierarchy(Topology):
    """K = Π_j K_j recursive hierarchy (chip < slice < pod < …): processor
    k has mixed-radix coordinates (c_0, …, c_{L−1}) with level 0 least
    significant — ``k = c_0 + K_0·(c_1 + K_1·(c_2 + …))``. Level 0 siblings
    (same coordinates above level 0) have a private fast link per ordered
    pair; two processors whose highest differing coordinate is level j ≥ 1
    share ONE trunk per ordered pair of level-j domains under their common
    parent — the same contention model as :class:`TwoLevel`, applied
    recursively. ``Hierarchy(levels=(I, G))`` prices identically to
    ``TwoLevel(k_intra=I, k_inter=G)``.

    ``levels`` is innermost (fastest) → outermost (slowest); ``costs`` is the
    matching per-level α/β tuple (default: :func:`default_level_costs`)."""

    levels: tuple[int, ...]
    costs: tuple[LinkCost, ...] | None = None
    name: str = "hierarchy"

    def __post_init__(self):
        if not self.levels or any(k < 1 for k in self.levels):
            raise ValueError(f"levels must be positive, got {self.levels}")
        if self.costs is not None and len(self.costs) != len(self.levels):
            raise ValueError(
                f"need one LinkCost per level: {len(self.costs)} costs "
                f"for {len(self.levels)} levels"
            )

    @property
    def n(self):  # type: ignore[override]
        out = 1
        for k in self.levels:
            out *= k
        return out

    def coords(self, k: int) -> tuple[int, ...]:
        """Mixed-radix digits of processor k, level 0 first."""
        out = []
        for sz in self.levels:
            out.append(k % sz)
            k //= sz
        return tuple(out)

    def level_cost(self, j: int) -> LinkCost:
        costs = self.costs if self.costs is not None else default_level_costs(
            len(self.levels)
        )
        return costs[j]

    def route(self, src, dst):
        if src == dst:
            return ()
        cs, cd = self.coords(src), self.coords(dst)
        j = max(i for i in range(len(self.levels)) if cs[i] != cd[i])
        if j == 0:
            return (("lvl", 0, src, dst),)
        # one trunk per ordered (src-domain, dst-domain) pair of level-j
        # siblings under their common parent — ALL their traffic shares it
        parent = tuple(cs[j + 1 :])
        return (("lvl", j, parent, cs[j], cd[j]),)

    def link_cost(self, link):
        return self.level_cost(link[1])


# ---------------------------------------------------------------------------
# α-β estimator
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TimeEstimate:
    total: float  # seconds
    per_round: tuple[float, ...]
    max_contention: int  # max #messages sharing one link in any round
    max_link_elems: int  # max elements crossing one link in any round

    @property
    def rounds(self) -> int:
        return len(self.per_round)


def round_link_loads(topo: Topology, messages: dict) -> dict:
    """{link: (n_messages, elements)} for one round's message map."""
    loads: dict = {}
    for (src, dst), elems in messages.items():
        for link in topo.route(src, dst):
            cnt, tot = loads.get(link, (0, 0))
            loads[link] = (cnt + 1, tot + elems)
    return loads


def schedule_time(
    topo: Topology, rounds: list, payload_elems: int = 1
) -> TimeEstimate:
    """Price a round schedule on ``topo``. Each round: every link serializes
    its traffic (#msgs·α + elements·payload·β) and the round lasts as long as
    its busiest link; rounds are synchronous so totals add."""
    per_round = []
    max_cont = 0
    max_load = 0
    for messages in rounds:
        loads = round_link_loads(topo, messages)
        t = 0.0
        for link, (cnt, elems) in loads.items():
            c = topo.link_cost(link)
            bw = elems * payload_elems * c.beta * (1.0 + c.gamma * (cnt - 1))
            t = max(t, cnt * c.alpha + bw)
            max_cont = max(max_cont, cnt)
            max_load = max(max_load, elems)
        per_round.append(t)
    return TimeEstimate(
        total=sum(per_round),
        per_round=tuple(per_round),
        max_contention=max_cont,
        max_link_elems=max_load,
    )


def make_topology(
    name: str,
    K: int,
    *,
    k_intra: int | None = None,
    levels: tuple[int, ...] | None = None,
    intra: LinkCost = ICI,
    inter: LinkCost = DCI,
) -> Topology:
    """Factory for the CLI / autotuner: name ∈ {flat, ring, torus, torus3d,
    two-level, hierarchy}. ``hierarchy`` takes ``levels`` (innermost →
    outermost, Π levels = K; default: balanced three-level split of K);
    ``torus3d`` reuses ``levels`` as (cols, rows, depth) dims (default:
    balanced factorization)."""
    if name == "flat":
        return FullyConnected(K, cost=intra)
    if name == "ring":
        return Ring(K, cost=intra)
    if name == "torus":
        rows = k_intra or _near_square(K)
        if K % rows:
            raise ValueError(f"torus needs rows | K, got rows={rows}, K={K}")
        return Torus2D(rows, K // rows, cost=intra)
    if name == "torus3d":
        dims = tuple(levels) if levels else default_levels(K, 3)
        if len(dims) != 3:
            raise ValueError(f"torus3d needs 3 dims, got {dims}")
        cols, rows, depth = dims
        if cols * rows * depth != K:
            raise ValueError(f"torus3d needs Π dims = K: {dims} vs K={K}")
        return Torus3D(depth=depth, rows=rows, cols=cols, cost=intra)
    if name == "two-level":
        ki = k_intra or _near_square(K)
        if K % ki:
            raise ValueError(f"two-level needs k_intra | K, got {ki}, K={K}")
        return TwoLevel(k_intra=ki, k_inter=K // ki, intra=intra, inter=inter)
    if name == "hierarchy":
        lv = tuple(levels) if levels else default_levels(K)
        prod = 1
        for k in lv:
            prod *= k
        if prod != K:
            raise ValueError(f"hierarchy needs Π levels = K: {lv} vs K={K}")
        return Hierarchy(levels=lv, costs=default_level_costs(len(lv), intra, inter))
    raise ValueError(f"unknown topology {name!r}")


def default_levels(K: int, n_levels: int = 3) -> tuple[int, ...]:
    """Balanced ``n_levels``-way factorization of K, innermost largest
    (biggest domain on the fastest links): peel the most balanced divisor
    off the outside repeatedly. Unsplittable remainders collapse to trivial
    OUTERMOST levels (K prime → (K, 1, 1)), so level 0 is never trivial."""
    outer = []  # outermost-first factors peeled so far
    rest = K
    for j in range(n_levels - 1, 0, -1):
        if rest <= 1:
            break
        # outermost factor ≈ rest^(1/(j+1)); take the largest divisor ≤ that
        target = round(rest ** (1.0 / (j + 1)))
        d = 1
        for cand in range(2, rest + 1):
            if rest % cand == 0 and cand <= max(target, 2):
                d = cand
        if d == 1 or d == rest:  # no useful split left: keep rest innermost
            break
        outer.append(d)
        rest //= d
    out = [rest] + list(reversed(outer))  # innermost first
    out += [1] * (n_levels - len(out))
    return tuple(out)


def _near_square(K: int) -> int:
    """Largest divisor of K not exceeding √K."""
    best = 1
    d = 1
    while d * d <= K:
        if K % d == 0:
            best = d
        d += 1
    return best
