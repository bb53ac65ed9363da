"""Quickstart (PyTorch port): all-to-all encode in 30 lines.

Every one of K=16 processors holds a packet; each wants a distinct linear
combination (a column of A). The universal prepare-and-shoot algorithm does
it in C1 = ⌈log2 K⌉ = 4 rounds moving C2 = 6 elements per port — vs 15 for
an all-gather. Runs on the card unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core import CostModel, Field, M31, a2a_encode, plan_for
from repro_torch.core.field import to_numpy
from repro_torch.core.matrices import random_matrix, random_vector
from repro_torch.core.prepare_shoot import encode_oracle


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    K = 16
    f = Field(M31)

    A = random_matrix(f, K, seed=0)  # ANY matrix — the universal promise
    x = random_vector(f, K, seed=1)

    out, report = a2a_encode(x, A, p=1, device=args.device)

    assert np.array_equal(to_numpy(out).astype(np.uint64), encode_oracle(x, A))
    m = CostModel()
    print(f"algorithm      : {report.algorithm}")
    print(f"rounds C1      : {report.c1}   (lower bound {report.c1_lower} — optimal: {report.c1_optimal})")
    print(f"elements C2    : {report.c2}   (vs all-gather baseline {K - 1})")
    print(f"modelled time  : {report.time * 1e6:.2f} µs under the α-β model (β={m.beta * 1e6:g}µs, "
          f"τ=4B/{4 / m.tau / 1e9:g}GBps: the reference's constants, not measured on this card)")

    # structured matrices get the specific algorithms (exponentially better C2):
    q = 2013265921
    plan = plan_for("dft", K, p=1, q=q)
    xq = random_vector(Field(q), K, seed=2)
    out2, report2 = a2a_encode(xq, plan=plan, q=q, device=args.device)
    print(f"\nDFT butterfly  : C1 = C2 = {report2.c2} (strictly optimal, Theorem 2)")
    return {"universal": (out, report), "dft": (out2, report2)}


if __name__ == "__main__":
    main()
