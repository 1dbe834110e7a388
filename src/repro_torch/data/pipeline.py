"""Data pipeline: deterministic synthetic token streams (for benchmarks,
dry-runs and smoke tests) and a byte-level text corpus reader.  The
port's copy of ``repro/data/pipeline.py``: numpy batches, which the
train step moves to the card.

Both are *step-indexed*: ``batch(step)`` is a pure function of (seed,
step), so a restarted job resumes with exactly the data it would have
seen — the property checkpoint/restart tests rely on, and what a
production loader must guarantee for reproducible multi-pod training
(each host slices its own shard of the global batch).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticDataset:
    """Markov-ish synthetic tokens with local structure (so loss can fall)."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def _zipf(self, rng, size):
        # skewed unigram distribution (learnable in tens of steps) with
        # local 8-fold repetition (learnable copy structure)
        u = rng.random(size)
        return (self.vocab * u**3).astype(np.int32) % self.vocab

    def batch(self, step: int, *, host_index: int = 0, num_hosts: int = 1) -> dict:
        b = self.global_batch // num_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host_index]))
        base = self._zipf(rng, (b, self.seq_len // 8 + 2))
        toks = np.repeat(base, 8, axis=1)[:, : self.seq_len + 1]
        noise = self._zipf(rng, toks.shape)
        mask = rng.random(toks.shape) < 0.1
        toks = np.where(mask, noise, toks).astype(np.int32)
        return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


@dataclasses.dataclass(frozen=True)
class ByteDataset:
    """Byte-level LM corpus from a file; vocab = 256 + 1 pad."""

    path: str
    seq_len: int
    global_batch: int
    seed: int = 0

    def __post_init__(self):
        data = np.fromfile(self.path, dtype=np.uint8)
        object.__setattr__(self, "_data", data)

    @property
    def vocab(self) -> int:
        return 257

    def batch(self, step: int, *, host_index: int = 0, num_hosts: int = 1) -> dict:
        b = self.global_batch // num_hosts
        data = self._data
        n = len(data) - self.seq_len - 1
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host_index]))
        starts = rng.integers(0, max(n, 1), size=b)
        toks = np.stack([
            data[s : s + self.seq_len + 1].astype(np.int32) for s in starts
        ])
        return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
