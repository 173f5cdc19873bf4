"""Deterministic sharded data pipeline.

Synthetic-LM mode generates a reproducible Zipf-ish token stream with local
n-gram structure (so the loss actually decreases during the example train
runs); file mode memory-maps a flat .bin of token ids and packs fixed-length
sequences. Every host/process draws only its own shard (seeded by
(seed, step, shard)), so restarts and elastic re-sharding are deterministic:
step k always yields the same global batch regardless of topology.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    path: str | None = None       # tokenized .bin (uint16/uint32) or None
    dtype: str = "uint16"


class TokenStream:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._mm = None
        if cfg.path:
            self._mm = np.memmap(cfg.path, dtype=np.dtype(cfg.dtype), mode="r")

    def _synthetic(self, step: int, shard: int, n_shards: int) -> np.ndarray:
        cfg = self.cfg
        bs = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, shard]))
        # Zipf marginal + order-1 structure: tokens partly copy t-1 (+1 mod V)
        z = rng.zipf(1.3, size=(bs, cfg.seq_len + 1)).astype(np.int64)
        base = np.clip(z, 1, cfg.vocab - 1)
        copy_mask = rng.random((bs, cfg.seq_len + 1)) < 0.5
        out = base.copy()
        for t in range(1, cfg.seq_len + 1):
            out[:, t] = np.where(copy_mask[:, t],
                                 (out[:, t - 1] + 1) % cfg.vocab, base[:, t])
        return out.astype(np.int32)

    def _from_file(self, step: int, shard: int, n_shards: int) -> np.ndarray:
        cfg = self.cfg
        bs = cfg.global_batch // n_shards
        span = cfg.seq_len + 1
        n_seq = (len(self._mm) - 1) // span
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, shard]))
        idx = rng.integers(0, n_seq, size=bs)
        rows = [np.asarray(self._mm[i * span:(i + 1) * span]) for i in idx]
        return np.stack(rows).astype(np.int32)

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        """Returns {'tokens': (bs, S), 'labels': (bs, S)} for this shard."""
        seq = (self._from_file if self._mm is not None else self._synthetic)(
            step, shard, n_shards)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def global_batch(self, step: int) -> dict:
        return self.batch(step, 0, 1)
