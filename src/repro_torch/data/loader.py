# Copied from src/repro/data/loader.py (the port keeps its own copy).
"""Deterministic sharded loader: shuffled random access through the learned
index, packed to fixed (batch, seq_len) with next-token labels.

Determinism + elasticity: the global sample order is a seeded permutation of
epochs; worker ``dp_rank`` of ``dp_size`` takes samples ``i * dp_size +
dp_rank``. The loader is resumable from (epoch, cursor) — stored in every
checkpoint — and re-sharding to a different dp_size replays the SAME global
order, so an elastic re-mesh mid-epoch loses no samples (runtime/elastic.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .store import PackedDocStore

PAD = -1


@dataclasses.dataclass
class LoaderState:
    epoch: int = 0
    cursor: int = 0          # global sample cursor within the epoch


class ShardedLoader:
    def __init__(self, store: PackedDocStore, batch: int, seq_len: int,
                 dp_rank: int = 0, dp_size: int = 1, seed: int = 17):
        self.store = store
        self.batch = batch
        self.seq_len = seq_len
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.seed = seed
        self.state = LoaderState()

    def _order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(self.store.n_docs)

    def set_shard(self, dp_rank: int, dp_size: int) -> None:
        """Elastic re-shard: same global order, new stride."""
        self.dp_rank, self.dp_size = dp_rank, dp_size

    def next_batch(self) -> dict:
        """(tokens, labels) (B, S) int32; advances the resumable cursor.

        One document per row (truncated/padded to seq_len+1): every rank
        consumes exactly ``batch`` global samples per step, so the global
        cursor advances uniformly across ranks — the property the elastic
        re-shard relies on (same order, new stride, no loss/duplication).
        Labels are -1 (masked in the loss) beyond the document."""
        rows = np.zeros((self.batch, self.seq_len + 1), np.int32)
        mask = np.zeros((self.batch, self.seq_len + 1), bool)
        order = self._order(self.state.epoch)
        for b in range(self.batch):
            if self.state.cursor >= len(order) * self.dp_size:
                self.state.epoch += 1
                self.state.cursor = 0
                order = self._order(self.state.epoch)
            gidx = self.state.cursor + self.dp_rank
            self.state.cursor += self.dp_size
            doc = self.store.get(int(order[gidx % len(order)]))
            n = min(len(doc), self.seq_len + 1)
            rows[b, :n] = doc[:n]
            mask[b, :n] = True
        labels = np.where(mask[:, 1:], rows[:, 1:], -1)
        return {"tokens": rows[:, :-1].astype(np.int32),
                "labels": labels.astype(np.int32)}

    # -- resume ----------------------------------------------------------
    def snapshot(self) -> dict:
        return {"epoch": self.state.epoch, "cursor": self.state.cursor}

    def restore(self, snap: dict) -> None:
        self.state = LoaderState(int(snap["epoch"]), int(snap["cursor"]))
