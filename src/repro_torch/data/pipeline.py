"""Deterministic sharded synthetic data — a copy of ``src/repro/data/pipeline.py:31-101``.

numpy only, so the batches are byte-identical to the reference's
(``tests/test_torch_pipeline.py`` holds them so):

- **stateless addressing** — a batch is a pure function of ``(seed, step,
  dp_rank)``, so a restart needs no loader state and a re-shard re-addresses;
- **learnable structure** — noisy period-``P`` repetitions of a random base
  pattern drawn from an effective vocab slice, so the loss falls quickly;
- **per-rank sharding** — each data-parallel rank builds only its
  ``global_batch / dp_size`` rows.

The reference's modality stubs (``frames_shape``, ``patches_shape``) and its
``WorkStealingBalancer`` are not copied: the port has no enc-dec or vision
family and no multi-host trainer yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

__all__ = ["SyntheticLM", "ShardedPipeline"]


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Deterministic synthetic language: noisy periodic repetition."""

    vocab_size: int
    seq_len: int
    seed: int = 0
    period: int = 64
    noise: float = 0.05
    vocab_eff: int = 1024  # patterns drawn from a slice ⇒ denser supervision

    def sample(self, step: int, row: int) -> np.ndarray:
        """One example: tokens[seq_len + 1] (inputs + shifted targets)."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, row]))
        v = min(self.vocab_eff, self.vocab_size)
        base = rng.integers(0, v, size=self.period)
        reps = int(np.ceil((self.seq_len + 1) / self.period))
        seq = np.tile(base, reps)[: self.seq_len + 1]
        flips = rng.random(self.seq_len + 1) < self.noise
        seq = np.where(flips, rng.integers(0, v, size=self.seq_len + 1), seq)
        return seq.astype(np.int32)


@dataclasses.dataclass
class ShardedPipeline:
    """Per-rank view of the global batch; batches addressed by step."""

    gen: SyntheticLM
    global_batch: int
    dp_rank: int = 0
    dp_size: int = 1

    def __post_init__(self):
        if self.global_batch % self.dp_size:
            raise ValueError(f"global batch {self.global_batch} is not a multiple of dp_size {self.dp_size}")
        self.local_batch = self.global_batch // self.dp_size

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rows = range(self.dp_rank * self.local_batch, (self.dp_rank + 1) * self.local_batch)
        seqs = np.stack([self.gen.sample(step, r) for r in rows])
        return {"tokens": seqs[:, :-1], "targets": seqs[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def reshard(self, dp_rank: int, dp_size: int) -> "ShardedPipeline":
        """Elastic re-mesh: same stream, new rank layout (stateless)."""
        return dataclasses.replace(self, dp_rank=dp_rank, dp_size=dp_size)
