"""Synthetic sharded LM data pipeline: deterministic, resumable, elastic.

A copy of ``repro/data/pipeline.py`` (pure numpy, so the port keeps its own
copy rather than importing the reference): every batch is a pure function
of ``(seed, step, shard_index, num_shards)`` through counter-based RNG
(numpy Philox), so the port's tokens equal the reference's bit for bit. No
data files, no coordination: a restarted or re-sharded worker regenerates
exactly its shard of any step, and the iterator's only state is the step.

The token stream is a learnable synthetic language: a fixed random Markov
chain (per seed) over the vocab with a skewed transition table, plus
periodic copy motifs, so the cross-entropy under it is well below uniform.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    branching: int = 8          # out-degree of the Markov chain
    motif_len: int = 16         # copy-motif period (0 disables)


class SyntheticLMDataset:
    """Deterministic synthetic LM token stream, shardable by batch row."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # the "language": each token has `branching` likely successors with
        # Zipf-ish weights; built once per seed, identical on every worker.
        rng = np.random.default_rng(np.random.PCG64(cfg.seed))
        V = cfg.vocab_size
        self._succ = rng.integers(0, V, size=(V, cfg.branching), dtype=np.int32)
        w = 1.0 / np.arange(1, cfg.branching + 1)
        self._w = (w / w.sum()).astype(np.float64)

    # -- core: batch as a pure function of (step, shard) ---------------------
    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        assert cfg.global_batch % num_shards == 0, (cfg.global_batch, num_shards)
        rows = cfg.global_batch // num_shards
        # counter-based: key = (seed, step, shard); no sequential state
        rng = np.random.default_rng(
            np.random.Philox(key=cfg.seed, counter=[step, shard, 0, 0]))
        B, S, V = rows, cfg.seq_len, cfg.vocab_size

        tokens = np.empty((B, S), np.int32)
        tokens[:, 0] = rng.integers(0, V, size=B)
        choices = rng.choice(cfg.branching, size=(B, S), p=self._w)
        for t in range(1, S):
            tokens[:, t] = self._succ[tokens[:, t - 1], choices[:, t]]
        if cfg.motif_len and S >= 2 * cfg.motif_len:
            # splice copy motifs: second half of each motif window repeats the
            # first half -> learnable induction pattern
            m = cfg.motif_len
            for start in range(0, S - 2 * m + 1, 4 * m):
                tokens[:, start + m:start + 2 * m] = tokens[:, start:start + m]
        return {"tokens": tokens}

    def entropy_floor(self) -> float:
        """Cross-entropy of the true chain (nats) — the loss floor."""
        return float(-(self._w * np.log(self._w)).sum())


def make_batch_iterator(cfg: DataConfig, *, start_step: int = 0,
                        shard: int = 0, num_shards: int = 1) -> Iterator:
    """Resumable iterator: yields (step, batch) from ``start_step``."""
    ds = SyntheticLMDataset(cfg)
    step = start_step
    while True:
        yield step, ds.batch(step, shard, num_shards)
        step += 1
