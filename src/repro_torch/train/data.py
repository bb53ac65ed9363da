"""Synthetic deterministic LM data pipeline.

Produces an infinite stream of (tokens, labels) batches, deterministic in
(seed, step, shard) — so a restarted job resumes mid-stream exactly (the
checkpoint stores only the step counter). A background prefetch thread
keeps ``depth`` steps ready.

The generator is a mixture of Zipf-distributed unigrams and short repeated
motifs, giving a non-trivial learnable distribution. It is pure numpy and
draws exactly what the reference package's ``train/data.py`` draws, so both
packages train on the same batches bit for bit.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.field import resolve_device


@dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    zipf_a: float = 1.3
    motif_len: int = 8
    motif_prob: float = 0.5
    n_motifs: int = 64


class SyntheticLM:
    def __init__(self, cfg: ModelConfig, dcfg: DataConfig = DataConfig()):
        self.cfg = cfg
        self.dcfg = dcfg
        rng = np.random.default_rng(dcfg.seed)
        v = cfg.vocab_size
        self.motifs = rng.integers(0, v, size=(dcfg.n_motifs, dcfg.motif_len))
        # Zipf over the vocab (renormalized, truncated)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = ranks ** (-dcfg.zipf_a)
        self.p = p / p.sum()

    def batch(self, step: int, batch_size: int, seq_len: int, shard: int = 0, n_shards: int = 1):
        """Deterministic batch for (step, shard): numpy ``int32`` arrays."""
        rng = np.random.default_rng(np.random.SeedSequence([self.dcfg.seed, step, shard, n_shards]))
        B = batch_size
        toks = rng.choice(self.cfg.vocab_size, size=(B, seq_len), p=self.p)
        # overlay motifs
        n_spans = max(1, seq_len // (4 * self.dcfg.motif_len))
        for b in range(B):
            for _ in range(n_spans):
                if rng.random() < self.dcfg.motif_prob:
                    m = self.motifs[rng.integers(self.dcfg.n_motifs)]
                    start = rng.integers(0, max(1, seq_len - self.dcfg.motif_len))
                    toks[b, start : start + self.dcfg.motif_len] = m
        toks = toks.astype(np.int32)
        return {"tokens": toks, "labels": toks.copy()}


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


class Prefetcher:
    """Background-thread prefetch of deterministic batches; ``next()`` gives
    ``(step, batch)`` with the batch's tensors on ``device`` (``None``: the
    card)."""

    def __init__(self, ds: SyntheticLM, batch_size: int, seq_len: int, start_step: int = 0, depth: int = 2,
                 device=None):
        self.device = resolve_device(device)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            s = start_step
            while not self._stop.is_set():
                b = ds.batch(s, batch_size, seq_len)
                try:
                    self.q.put((s, b), timeout=1.0)
                    s += 1
                except queue.Full:
                    continue

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def next(self):
        step, b = self.q.get()
        return step, to_device(b, self.device)

    def close(self):
        self._stop.set()
        self.t.join(timeout=5.0)
