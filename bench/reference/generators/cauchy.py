"""The Cauchy generator ``A[i][j] = 1 / (x_i + y_j)`` over GF(q).

Every square submatrix of a Cauchy matrix is invertible, which is what lets a
coded checkpoint recover any f lost shards from any f surviving parities.
The points are the configuration's own (``x_points``, ``y_points``): all
distinct, and no ``x_i + y_j`` is 0 mod q.
"""

from __future__ import annotations

from ..field import check_field, inverse


def matrix(code: dict) -> list[list[int]]:
    q, K, N = code["q"], code["K"], code["N"]
    check_field(q)
    gen = code["generator"]
    xs = [int(v) % q for v in gen["x_points"]]
    ys = [int(v) % q for v in gen["y_points"]]
    if len(xs) != K or len(ys) != N:
        raise ValueError(f"Cauchy points: {len(xs)} x and {len(ys)} y for K = {K}, N = {N}")
    if len(set(xs + ys)) != K + N:
        raise ValueError("Cauchy points are not all distinct")
    return [[inverse(x + y, q) for y in ys] for x in xs]
