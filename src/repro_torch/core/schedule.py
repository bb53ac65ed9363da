"""Static round schedules for the paper's algorithms.

A *schedule* is everything that is independent of the input packets: which
processor talks to which (uniform shifts per round),
how buffers are laid out, and (for the specific algorithms) the precomputed
coefficient/twiddle tables with their Shoup duals.

Everything here is host-side numpy / python int (an own copy of the
reference package's ``repro.core.schedule``); the torch executors in
``prepare_shoot.py`` / ``draw_loose.py`` and the IR executor in
``dist/collectives.py`` consume these plans as constants.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bounds import ceil_log, ps_params
from .field import M31, Field, shoup_precompute
from .matrices import digit_reversal_permutation


def plan_constants(plan, key, make):
    """``make()`` once for each ``(plan, key)``: the constants an executor
    bakes from a plan (twiddles, Shoup duals, gather indices as tensors on one
    device) are built and uploaded at the first call and reused after it.

    They are kept in the plan's instance dict, which a frozen dataclass
    leaves writable (``functools.cached_property`` relies on the same), so
    they live exactly as long as the plan, are no field of it (equality and
    ``dataclasses.asdict`` do not see them), and no module holds state.
    """
    cache = plan.__dict__.setdefault("_constants", {})
    if key not in cache:
        cache[key] = make()
    return cache[key]


# ---------------------------------------------------------------------------
# prepare-and-shoot schedule (§IV)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PrepareShootPlan:
    K: int
    p: int
    L: int
    Tp: int
    Ts: int
    m: int
    n: int
    # prepare round t (1-based) sends the whole buffer to k + rho*m/(p+1)^t
    prepare_shifts: tuple[tuple[int, ...], ...]  # [round][rho-1] -> shift
    # shoot round t sends digit-t slices to k + rho*m*(p+1)^(t-1)
    shoot_shifts: tuple[tuple[int, ...], ...]
    # prepare buffer slot u holds x_{k - prepare_offsets[u]} at phase end
    prepare_offsets: tuple[int, ...]

    @property
    def c1(self) -> int:
        return self.Tp + self.Ts

    @property
    def c2(self) -> int:
        return (self.m - 1) // self.p + (self.n - 1) // self.p

    def to_ir(self, A=None, *, q: int = M31):
        from .ir import ir_prepare_shoot

        return ir_prepare_shoot(self, A, q=q)


def gather_rounds(N: int, p: int) -> tuple[tuple[tuple[int, int], ...], ...]:
    """Round schedule fully gathering N cyclic packets: each round every
    processor sends a prefix of its (contiguous-offset) buffer to p partners.

    Returns per round a tuple of ``(shift, count)`` ports: send buffer slots
    [0, count) to processor k+shift (mod N). After round r the buffer holds
    offsets [0, min((p+1)^r, N)) — ⌈log_{p+1}N⌉ rounds total, C2 = Σ max
    count ≈ (N−1)/p (the optimal p-port all-gather of bounds.py). Shared by
    the allgather baseline and the hierarchical/multilevel intra phases.
    """
    rounds = []
    b = 1
    while b < N:
        ports = []
        for rho in range(1, p + 1):
            cnt = min(b, N - rho * b)
            if cnt > 0:
                ports.append((rho * b, cnt))
        rounds.append(tuple(ports))
        b = min(b * (p + 1), N)
    return tuple(rounds)


def plan_prepare_shoot(K: int, p: int) -> PrepareShootPlan:
    L, Tp, Ts, m, n = ps_params(K, p)
    prepare_shifts = []
    for t in range(1, Tp + 1):
        step = m // (p + 1) ** t
        prepare_shifts.append(tuple(rho * step for rho in range(1, p + 1)))
    shoot_shifts = []
    for t in range(1, Ts + 1):
        step = m * (p + 1) ** (t - 1)
        shoot_shifts.append(tuple(rho * step for rho in range(1, p + 1)))
    # offsets: buffer grows by concatenation [self, recv_1, .., recv_p] each
    # round; slot (rho*c + u) after round t holds offset rho*step_t + delta(u).
    offsets = [0]
    for t in range(1, Tp + 1):
        step = m // (p + 1) ** t
        base = list(offsets)
        for rho in range(1, p + 1):
            offsets.extend(rho * step + d for d in base)
    assert sorted(offsets) == list(range(m)), "prepare tree must cover [0, m)"
    return PrepareShootPlan(
        K=K,
        p=p,
        L=L,
        Tp=Tp,
        Ts=Ts,
        m=m,
        n=n,
        prepare_shifts=tuple(prepare_shifts),
        shoot_shifts=tuple(shoot_shifts),
        prepare_offsets=tuple(offsets),
    )


def coeff_mask(plan: PrepareShootPlan) -> np.ndarray:
    """First-coverage mask: contribution (slot u, variable l)
    is kept iff  l*m + prepare_offsets[u] < K.

    Every source residue j = (l*m + offset) mod K then contributes to each
    destination exactly once:  y_k = sum_{j=0}^{K-1} x_{k-j} A[k-j, k] = x~_k.
    This subsumes the paper's Eq. 2 set semantics and Eq. 3 overlap
    correction, and is exact for every K <= m*n (the paper's correction
    needs (n-1)m < K, which fails e.g. for its own Fig. 3 parameters).
    Shape (m, n) bool.
    """
    offs = np.asarray(plan.prepare_offsets)[:, None]
    l = np.arange(plan.n)[None, :]
    return (l * plan.m + offs) < plan.K


def live_slots(plan: PrepareShootPlan) -> int:
    """Number of live w variables: slot l is entirely masked (all-zero, never
    worth sending) iff l*m >= K. Live slots are l in [0, ceil(K/m))."""
    return -(-plan.K // plan.m)


def digit_reduction_slots(n: int, p: int, t: int, rho: int):
    """(dst_slots, src_slots) of the §IV digit-reduction over ``n`` slots,
    round ``t`` (1-based), port ``rho``: receiver slot l (digit_t = 0, lower
    digits 0) absorbs sender slot l + rho·(p+1)^{t-1}. The single source of
    truth for the shoot/inter-shoot slot algebra (dist.collectives and
    topo.hierarchical delegate here)."""
    radix = p + 1
    stride = radix ** (t - 1)
    l = np.arange(n)
    src = l + rho * stride
    valid = (src < n) & ((l // stride) % radix == 0) & (l % stride == 0)
    return l[valid], src[valid]


def digit_reduction_message_size(n: int, n_live: int, p: int, t: int, rho: int) -> int:
    """Live elements shipped on port rho in round t: the digit-reduction's
    sender slots below ``n_live`` (slots l ≥ n_live are identically zero)."""
    radix = p + 1
    stride = radix ** (t - 1)
    return sum(
        1
        for l in range(n)
        if (l // stride) % radix == rho and l % stride == 0 and l < n_live
    )


def shoot_round_message_size(plan: PrepareShootPlan, t: int, rho: int) -> int:
    """Elements sent on port rho in shoot round t (1-based): the live slots
    {l : digit_t(l) = rho, lower digits 0, l*m < K}."""
    return digit_reduction_message_size(plan.n, live_slots(plan), plan.p, t, rho)


def counted_c2(plan: PrepareShootPlan) -> int:
    """Exact C2 with live-slot accounting: equals the Theorem-1 closed form
    when m*n == K and is <= it otherwise (dead slots are never sent)."""
    c2 = (plan.m - 1) // plan.p  # prepare: Lemma 3
    for t in range(1, plan.Ts + 1):
        c2 += max(
            shoot_round_message_size(plan, t, rho) for rho in range(1, plan.p + 1)
        )
    return c2


def shoot_coeff_tensor(plan: PrepareShootPlan, A: np.ndarray) -> np.ndarray:
    """coef[k, u, l] = A[(k - prepare_offsets[u]) mod K, (k + l*m) mod K].

    The w-variable initialization (Algorithm 1 line 1) becomes the modular
    contraction  w[k, l] = Σ_u buf[k, u] * coef[k, u, l]  — the gf_matmul
    hot spot. Built host-side with static indices (A may be a runtime tensor
    in the torch path; there we gather with the same indices instead).
    """
    K, m, n = plan.K, plan.m, plan.n
    k = np.arange(K)[:, None, None]
    u = np.asarray(plan.prepare_offsets)[None, :, None]
    l = np.arange(n)[None, None, :]
    rows = (k - u) % K
    cols = (k + l * m) % K
    return np.asarray(A)[rows, cols]


def shoot_coeff_indices(plan: PrepareShootPlan) -> tuple[np.ndarray, np.ndarray]:
    """(rows, cols) index tensors for gathering the coef tensor from a
    runtime A inside jit."""
    K, m, n = plan.K, plan.m, plan.n
    k = np.arange(K)[:, None, None]
    u = np.asarray(plan.prepare_offsets)[None, :, None]
    l = np.arange(n)[None, None, :]
    rows = (k - u) % K
    cols = (k + l * m) % K
    rows, cols = np.broadcast_arrays(rows, cols)
    return rows, cols


# ---------------------------------------------------------------------------
# DFT butterfly schedule (§V-A)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ButterflyPlan:
    K: int
    p: int  # radix = p+1
    H: int
    q: int
    beta: int  # primitive K-th root of unity
    # round t ∈ [0, H): processor k combines the radix values of its digit-t
    # group with coefficients twiddle[t][k, rho] = gamma(k mod (p+1)^{t+1})^rho
    twiddles: tuple[np.ndarray, ...]  # uint32 (K, radix)
    twiddles_shoup: tuple[np.ndarray, ...]  # uint32 (K, radix)
    inv_twiddles: tuple[np.ndarray, ...]  # inverse-butterfly coefficients
    inv_twiddles_shoup: tuple[np.ndarray, ...]
    digit_rev: np.ndarray  # the row permutation the butterfly applies

    @property
    def radix(self) -> int:
        return self.p + 1

    @property
    def c1(self) -> int:
        return self.H

    @property
    def c2(self) -> int:
        return self.H

    def to_ir(self, inverse: bool = False):
        from .ir import ir_butterfly

        return ir_butterfly(self, inverse=inverse)


def plan_butterfly(K: int, p: int, q: int) -> ButterflyPlan:
    """Build the radix-(p+1) butterfly for K = (p+1)^H over GF(q).

    Requires K | q-1 (so a primitive K-th root of unity exists).
    Round-t coefficient for receiver k, sender-digit rho (Eq. 9):
        twiddle[t][k, rho] = gamma_{k_t k_{t-1}..k_0} ^ rho
    with gamma_{d_{h-1}..d_0} = (beta^{Σ d_i (p+1)^i})^{(p+1)^{H-h}} (Eq. 5).
    """
    radix = p + 1
    H = ceil_log(K, radix)
    if radix**H != K:
        raise ValueError(f"K={K} is not a power of {radix}")
    f = Field(q)
    beta = f.root_of_unity(K)
    k = np.arange(K, dtype=np.int64)
    twiddles, tw_shoup, inv_tw, inv_tw_shoup = [], [], [], []
    for t in range(H):
        h = t + 1  # gamma index uses digits 0..t → level h = t+1
        low = k % (radix ** (t + 1))  # k_t..k_0 as an integer
        # gamma = (beta^low)^{(p+1)^{H-h}}
        gamma = f.pow(f.pow(np.full(K, beta, dtype=np.uint64), low), radix ** (H - h))
        tw = np.stack([f.pow(gamma, rho) for rho in range(radix)], axis=1)
        twiddles.append(tw.astype(np.uint32))
        tw_shoup.append(shoup_precompute(tw, q))
        # inverse round: per digit-t group, the radix×radix matrix
        # A_k^{(t)}[r, rho] = gamma(digit_t←r)^rho is Vandermonde (Eq. 11);
        # invert it per group and hand each processor its row.
        group_lo = k % (radix**t)
        group_hi = k // (radix ** (t + 1))
        inv_rows = np.zeros((K, radix), dtype=np.uint64)
        # group members share (group_hi, group_lo); member r has digit_t = r
        base = (group_hi * radix) * (radix**t) + group_lo  # digit_t = 0 member
        uniq = np.unique(base)
        for b in uniq:
            members = b + np.arange(radix) * (radix**t)
            V = tw[members, :]  # V[r, rho] = gamma_r^rho
            Vinv = f.inv_matrix(V)
            # Q(k_r, t) = Σ_rho Vinv[r, rho] Q(k_rho, t+1)
            inv_rows[members, :] = Vinv
        inv_tw.append(inv_rows.astype(np.uint32))
        inv_tw_shoup.append(shoup_precompute(inv_rows, q))
    return ButterflyPlan(
        K=K,
        p=p,
        H=H,
        q=q,
        beta=int(beta),
        twiddles=tuple(twiddles),
        twiddles_shoup=tuple(tw_shoup),
        inv_twiddles=tuple(inv_tw),
        inv_twiddles_shoup=tuple(inv_tw_shoup),
        digit_rev=digit_reversal_permutation(K, radix),
    )


def butterfly_group_perms(K: int, radix: int, t: int) -> list[np.ndarray]:
    """For each d ∈ [1, radix): permutation dst[k] = k with digit t
    incremented by d (mod radix) — the ppermute pairs of round t."""
    k = np.arange(K, dtype=np.int64)
    step = radix**t
    digit = (k // step) % radix
    perms = []
    for d in range(1, radix):
        dst = k + ((digit + d) % radix - digit) * step
        perms.append(dst)
    return perms


# ---------------------------------------------------------------------------
# draw-and-loose decomposition (§V-B)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DrawLoosePlan:
    """K = M · Z, Z = (p+1)^H; processor P_{i,j} = j + Z·i.

    draw:  Z parallel M×M prepare-and-shoot encodes over stride-Z subgroups
           computing V[w, i] = alpha_i^{Z·w}, then local ·alpha_i^{rev(j)}.
    loose: M parallel Z-point radix-(p+1) butterflies over contiguous groups.

    Digit-reversal bookkeeping: the butterfly of §V-A maps inputs
    v to out[j] = Σ_ℓ v_{rev(ℓ)} ω^{ℓ j}. Feeding it in[j] = f_{rev(j)}(α_i)
    yields the TRUE evaluations x̃_{i,j} = Σ_ℓ f_ℓ(α_i) ω^{ℓ j}. We get
    in[j] = f_{rev(j)}(α_i) for free by declaring that processor P_{w,j}'s
    packet is source symbol x_{w, rev(j)} (a relabeling, i.e. a fixed ROW
    permutation of the Vandermonde generator — the paper's "up to
    permutation"). Concretely: the generator computed is
        G[k, c] = points[c] ** source_perm[k],
    source_perm[k] = Z·(k//Z) + rev(k mod Z), points[c] = α_{c//Z}·ω^{c mod Z},
    and the draw-phase local multiplier at processor k is α_{k//Z}^{rev(k mod Z)}.
    """

    K: int
    p: int
    M: int
    H: int
    Z: int
    q: int
    alphas: np.ndarray  # (M,) subgroup evaluation points alpha_i
    omega: int  # primitive Z-th root of unity (beta_j = omega^j)
    draw_plan: PrepareShootPlan | None  # None when M == 1
    draw_matrix: np.ndarray  # (M, M) V[w, i] = alpha_i^{Z w}
    loose_plan: ButterflyPlan | None  # None when H == 0
    points: np.ndarray  # (K,) evaluation point of processor c: alpha_{c//Z}·omega^{c%Z}
    source_perm: np.ndarray  # (K,) coefficient index held by processor k
    local_scale: np.ndarray  # (K,) uint32 draw-phase multiplier alpha_i^{rev(j)}
    local_scale_shoup: np.ndarray  # (K,) uint32

    @property
    def c1(self) -> int:
        c = self.loose_plan.H if self.loose_plan else 0
        if self.draw_plan:
            c += self.draw_plan.c1
        return c

    @property
    def c2(self) -> int:
        c = self.loose_plan.H if self.loose_plan else 0
        if self.draw_plan:
            c += self.draw_plan.c2
        return c

    def to_ir(self):
        from .ir import ir_draw_loose

        return ir_draw_loose(self)


def plan_draw_loose(K: int, p: int, q: int, seed: int = 0) -> DrawLoosePlan:
    """Factor K = M·(p+1)^H with H maximal s.t. (p+1)^H | gcd(K, q-1),
    choose injective phi (random distinct exponents) per §V-B."""
    radix = p + 1
    f = Field(q)
    H = 0
    while K % radix ** (H + 1) == 0 and (q - 1) % radix ** (H + 1) == 0:
        H += 1
    Z = radix**H
    M = K // Z
    omega = f.root_of_unity(Z) if Z > 1 else 1
    # alpha_i = g^{phi(i)}, phi injective into [0, (q-1)/Z - 1]; exponents are
    # multiples of nothing special — distinctness of alpha_i*omega^j follows
    # because alpha exponents are distinct mod (q-1)/Z (paper §V-B).
    rng = np.random.default_rng(seed)
    space = (q - 1) // Z
    if M > space:
        raise ValueError("cannot choose M distinct alpha exponents")
    exps = rng.choice(space, size=M, replace=False)
    alphas = f.pow(np.full(M, f.generator, dtype=np.uint64), exps)
    draw_plan = plan_prepare_shoot(M, p) if M > 1 else None
    # V[w, i] = alpha_i^{Z·w}
    aZ = f.pow(alphas, Z)
    V = np.stack([f.pow(aZ, w) for w in range(M)], axis=0)
    loose_plan = plan_butterfly(Z, p, q) if H > 0 else None
    i = np.arange(K) // Z
    jj = np.arange(K) % Z
    points = f.mul(alphas[i], f.pow(np.full(K, omega, dtype=np.uint64), jj))
    if len(np.unique(points)) != K:
        raise RuntimeError("evaluation points not distinct — bad phi choice")
    rev = loose_plan.digit_rev if loose_plan is not None else np.arange(Z)
    source_perm = Z * i + rev[jj]
    local_scale = f.pow(alphas[i], rev[jj]).astype(np.uint32)
    return DrawLoosePlan(
        K=K,
        p=p,
        M=M,
        H=H,
        Z=Z,
        q=q,
        alphas=alphas,
        omega=int(omega),
        draw_plan=draw_plan,
        draw_matrix=V,
        loose_plan=loose_plan,
        points=points,
        source_perm=source_perm,
        local_scale=local_scale,
        local_scale_shoup=shoup_precompute(local_scale, q),
    )


def draw_loose_target_matrix(plan: DrawLoosePlan) -> np.ndarray:
    """The K×K generator actually computed: G[k, c] = points[c]^source_perm[k]
    — a fixed row permutation of the Vandermonde matrix on ``plan.points``
    (still MDS; the paper's 'up to permutation')."""
    from .matrices import vandermonde

    f = Field(plan.q)
    V = vandermonde(f, plan.points)  # V[r, c] = points[c]^r
    return V[plan.source_perm, :]
