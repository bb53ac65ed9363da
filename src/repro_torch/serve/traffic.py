"""Synthetic serving traffic: seeded Poisson arrivals over a mixed
prompt-length distribution.

``poisson_trace`` is the reference's workload generator, copied:
exponential interarrival gaps at ``rate_rps`` requests per second, each
request drawing its prompt length from a weighted set of
:class:`LengthBand`\\ s (short chat turns vs. long documents) and its
token ids uniformly from the vocabulary. Everything is derived from one
``numpy`` Generator seed, so the fixed-batch baseline and the continuous
engine can be measured on the *same* trace and two benchmark runs produce
identical workloads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .scheduler import Request


@dataclass(frozen=True)
class LengthBand:
    """Uniform prompt-length band [lo, hi] with a sampling weight."""

    lo: int
    hi: int
    weight: float


#: default mixed-length workload: mostly short turns, a tail of long prompts
DEFAULT_MIX = (
    LengthBand(4, 16, 0.55),
    LengthBand(17, 48, 0.30),
    LengthBand(49, 120, 0.15),
)


def poisson_trace(
    n_requests: int,
    rate_rps: float,
    mix=DEFAULT_MIX,
    max_new_tokens: int = 16,
    vocab_size: int = 256,
    seed: int = 0,
) -> list[Request]:
    """``n_requests`` seeded requests, sorted by arrival time.

    Arrivals: cumulative Exp(1/rate_rps) gaps. Prompt lengths: pick a band
    by weight, then uniform within it. Generation budgets: uniform in
    [max(1, max_new_tokens // 2), max_new_tokens] so finishers stagger —
    the case continuous batching exists for.
    """
    if n_requests < 1:
        raise ValueError("need at least one request")
    if rate_rps <= 0:
        raise ValueError("rate_rps must be positive")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n_requests)
    arrivals = np.cumsum(gaps)
    weights = np.array([b.weight for b in mix], dtype=np.float64)
    weights = weights / weights.sum()
    bands = rng.choice(len(mix), size=n_requests, p=weights)
    lo_new = max(1, max_new_tokens // 2)
    reqs = []
    for i in range(n_requests):
        band = mix[int(bands[i])]
        plen = int(rng.integers(band.lo, band.hi + 1))
        prompt = rng.integers(1, vocab_size, size=plen).astype(np.int32).tolist()
        reqs.append(
            Request(
                id=f"req-{i:04d}",
                prompt=prompt,
                max_new_tokens=int(rng.integers(lo_new, max_new_tokens + 1)),
                arrival_s=float(arrivals[i]),
            )
        )
    return reqs
