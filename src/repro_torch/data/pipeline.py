"""Deterministic, shardable, resumable token data pipeline (reference:
``repro/data/pipeline.py``, copied: it is numpy-only, so the port yields
the same batches bit for bit).

Two sources:
* :class:`SyntheticSource` — seeded synthetic token streams (benchmarks,
  tests, dry-runs); exactly reproducible per (seed, step, shard).
* :class:`BinTokenSource` — memory-mapped flat binary token file (uint16/32),
  the standard "packed tokens" format.

Both are *stateless-seekable*: ``batch_at(step)`` is a pure function of the
step index, so checkpoint/restart resumes exactly (FT requirement) and any
data-parallel rank can compute its own shard without coordination.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticSource:
    vocab_size: int
    seed: int = 0

    def tokens_at(self, step: int, shard: int, shape) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        return rng.integers(0, self.vocab_size, shape, dtype=np.int32)


@dataclasses.dataclass
class BinTokenSource:
    path: str
    vocab_size: int
    dtype: str = "uint16"

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        assert len(self._data) > 0, f"empty token file: {self.path}"

    def tokens_at(self, step: int, shard: int, shape) -> np.ndarray:
        b, s = shape
        n = b * s
        total = len(self._data)
        # deterministic strided window per (step, shard); the modular index
        # wraps the read around the end of the file (and cycles a file
        # shorter than one batch), so any window is valid for any file size
        start = (step * 2_147_483_647 + shard * 97_003) % total
        idx = (start + np.arange(n)) % total
        return np.asarray(self._data[idx], dtype=np.int32).reshape(b, s)


@dataclasses.dataclass
class DataPipeline:
    """Yields {tokens, labels} batches for one data-parallel shard.

    global_batch is divided over n_shards; labels are next-token shifted.
    """
    source: object
    global_batch: int
    seq_len: int
    n_shards: int = 1
    shard: int = 0
    extra_specs: Optional[Dict] = None   # e.g. vlm patch embeds (stubbed)

    def __post_init__(self):
        assert self.global_batch % self.n_shards == 0
        self.local_batch = self.global_batch // self.n_shards

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        toks = self.source.tokens_at(step, self.shard,
                                     (self.local_batch, self.seq_len + 1))
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        if self.extra_specs:
            rng = np.random.default_rng(
                np.random.SeedSequence([17, step, self.shard]))
            for name, (shape, dtype) in self.extra_specs.items():
                batch[name] = rng.standard_normal(
                    (self.local_batch,) + tuple(shape)).astype(dtype)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
