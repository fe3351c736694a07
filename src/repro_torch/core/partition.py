# Copied from src/repro/core/partition.py (the port keeps its own copy).
"""Range partitioning of the key space over per-shard AULID indexes.

Production learned-index deployments scale by partitioning (Bigtable keeps
one small model per tablet); for us the partition is the structural move that
makes compaction stalls shard-local (DESIGN.md §9): each shard owns a host
``Aulid`` (with its own change journal and block device), so a hot shard
folding its overlay never rebuilds a cold shard's mirror.

The shard boundary table is seeded from bulkload key quantiles:
``bounds[s]`` is the *inclusive* upper key of shard ``s`` (the last shard is
unbounded above), and routing any key — read or write — is a single
``searchsorted`` over the (S-1)-entry table.

Since PR 8 the table is **versioned** (DESIGN.md §12): online split/merge
(``apply_split`` / ``apply_merge``) installs a new bounds array under a bumped
``version`` while every retired version stays in ``history`` for as long as
someone has it pinned.  In-flight work (an engine step, a background split
build) calls ``pin()`` to hold the version it routes on and ``unpin()`` when
done; unpinned non-current versions are garbage-collected.  Routing is still
one ``searchsorted`` — per version.  Split/merge planning (``plan_split``)
picks the median key of a shard so both halves are non-empty, and the apply
methods keep ``shards``/``bounds``/``history`` consistent so host, overlay,
and stacked-mirror views agree request-for-request with a monolithic index
(property-tested in ``tests/test_sharded_engine.py`` and
``tests/test_repartition.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from .aulid import Aulid, AulidConfig
from .blockdev import BlockDevice


@dataclasses.dataclass
class RangePartition:
    """Boundary table + per-shard host indexes (each with its own journal)."""

    bounds: np.ndarray          # (S-1,) u64 inclusive upper key per shard
    shards: list[Aulid]
    # versioned boundary table (DESIGN.md §12): monotonically increasing
    # version, per-version bounds snapshots, and pin counts keeping retired
    # versions alive while in-flight steps/builds still route on them
    version: int = 0
    history: dict[int, np.ndarray] = dataclasses.field(
        default_factory=dict, repr=False)
    _pins: dict[int, int] = dataclasses.field(
        default_factory=dict, repr=False)

    def __post_init__(self) -> None:
        if self.version not in self.history:
            self.history[self.version] = self.bounds

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def n_items(self) -> int:
        return sum(sh.n_items for sh in self.shards)

    # -------------------------------------------------------------- routing
    def bounds_at(self, version: Optional[int] = None) -> np.ndarray:
        """The boundary table of ``version`` (default: current).  Retired
        versions are only reachable while pinned (see :meth:`pin`)."""
        return self.history[self.version if version is None else version]

    def shard_of(self, key: int, version: Optional[int] = None) -> int:
        """One searchsorted over the (versioned) boundary table
        (DESIGN.md §9, §12)."""
        return int(np.searchsorted(self.bounds_at(version),
                                   np.uint64(int(key)), side="left"))

    def shard_of_batch(self, keys: np.ndarray,
                       version: Optional[int] = None) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.uint64)
        return np.searchsorted(self.bounds_at(version), keys,
                               side="left").astype(np.int32)

    # ----------------------------------------------------- version lifecycle
    def pin(self, version: Optional[int] = None) -> int:
        """Pin a boundary-table version (default: current) so its bounds stay
        in ``history`` across splits/merges; returns the pinned version."""
        v = self.version if version is None else int(version)
        assert v in self.history, f"version {v} already retired"
        self._pins[v] = self._pins.get(v, 0) + 1
        return v

    def unpin(self, version: int) -> None:
        """Release a pin; a retired version with zero pins is GC'd."""
        v = int(version)
        n = self._pins.get(v, 0)
        assert n > 0, f"unbalanced unpin of version {v}"
        if n == 1:
            del self._pins[v]
        else:
            self._pins[v] = n - 1
        self.gc_versions()

    def pinned_versions(self) -> dict[int, int]:
        """version -> pin count (snapshot copy, for stats/tests)."""
        return dict(self._pins)

    def gc_versions(self) -> None:
        """Drop retired (non-current) versions nobody has pinned."""
        for v in [v for v in self.history
                  if v != self.version and not self._pins.get(v)]:
            del self.history[v]

    # ------------------------------------------------- split/merge planning
    def spawn_index(self) -> Aulid:
        """A fresh empty shard index with the resident shards' config — the
        build target of a split/merge (custom ``dev_factory`` devices from
        bulkload are not reproduced; split products use plain block devices
        of the same block size)."""
        cfg = self.shards[0].cfg
        return Aulid(BlockDevice(block_bytes=cfg.block_bytes), cfg=cfg)

    def shard_items(self, s: int) -> tuple[np.ndarray, np.ndarray]:
        """Sorted (keys, payloads) resident in shard ``s``'s host index."""
        items = self.shards[s].scan(0, self.shards[s].n_items)
        keys = np.fromiter((k for k, _ in items), dtype=np.uint64,
                           count=len(items))
        pays = np.fromiter((p for _, p in items), dtype=np.uint64,
                           count=len(items))
        return keys, pays

    def plan_split(self, s: int) -> Optional[int]:
        """The split key for shard ``s``: the median resident key, chosen so
        both halves are non-empty (left takes keys <= split_key).  Returns
        None when the shard has fewer than two distinct keys."""
        keys, _ = self.shard_items(s)
        if len(keys) < 2:
            return None
        split_key = int(keys[len(keys) // 2 - 1])
        if split_key >= int(keys[-1]):   # all keys in the left half
            below = np.searchsorted(keys, np.uint64(split_key), side="left")
            if below == 0:
                return None              # fewer than two distinct keys
            split_key = int(keys[below - 1])
        return split_key

    def apply_split(self, s: int, split_key: int,
                    left: Aulid, right: Aulid) -> int:
        """Install a completed split of shard ``s`` at ``split_key`` (left
        takes keys <= split_key): replaces the shard with ``left``/``right``,
        inserts the new boundary, and bumps the version (retired bounds stay
        in ``history`` while pinned).  Returns the new version."""
        assert 0 <= s < self.num_shards
        assert s >= len(self.bounds) or split_key < int(self.bounds[s]), \
            "split key must fall strictly inside the shard's range"
        self.shards[s:s + 1] = [left, right]
        new_bounds = np.insert(self.bounds, s, np.uint64(int(split_key)))
        return self._install_bounds(new_bounds)

    def apply_merge(self, s: int, merged: Aulid) -> int:
        """Install a completed merge of shards ``s`` and ``s+1`` into
        ``merged``: drops the boundary between them and bumps the version.
        Returns the new version."""
        assert 0 <= s < self.num_shards - 1, "merge needs a right neighbor"
        self.shards[s:s + 2] = [merged]
        return self._install_bounds(np.delete(self.bounds, s))

    def _install_bounds(self, new_bounds: np.ndarray) -> int:
        self.bounds = np.asarray(new_bounds, dtype=np.uint64)
        self.version += 1
        self.history[self.version] = self.bounds
        self.gc_versions()
        return self.version

    # ------------------------------------------------------------ operations
    def insert(self, key: int, payload: int) -> None:
        self.shards[self.shard_of(key)].insert(key, payload)

    def update(self, key: int, payload: int) -> bool:
        return self.shards[self.shard_of(key)].update(key, payload)

    def delete(self, key: int) -> bool:
        return self.shards[self.shard_of(key)].delete(key)

    def lookup(self, key: int) -> Optional[int]:
        return self.shards[self.shard_of(key)].lookup(key)

    def scan(self, start_key: int, count: int) -> list[tuple[int, int]]:
        """Host-side cross-shard scan: drain the owning shard, then continue
        through successor shards (the host twin of the device mirror's
        shard-successor leaf chain)."""
        out: list[tuple[int, int]] = []
        for s in range(self.shard_of(start_key), self.num_shards):
            if len(out) >= count:
                break
            out.extend(self.shards[s].scan(
                start_key if not out else 0, count - len(out)))
        return out[:count]

    def check_invariants(self) -> None:
        assert len(self.bounds) == self.num_shards - 1
        assert np.all(self.bounds[1:] > self.bounds[:-1]), \
            "bounds must be strictly increasing"
        assert self.history[self.version] is self.bounds, \
            "current version must map to the live bounds"
        for v in self._pins:
            assert v in self.history and self._pins[v] > 0
        for v in self.history:
            assert v == self.version or self._pins.get(v, 0) > 0, \
                f"retired version {v} survived GC without pins"
        prev_hi = -1
        for s, sh in enumerate(self.shards):
            sh.check_invariants()
            lo = sh.first_leaf
            if sh.n_items == 0:
                continue
            ks = sh.leaf_keys[lo][: sh.leaf_count[lo]]
            if len(ks):
                assert int(ks[0]) > prev_hi or prev_hi < 0, \
                    f"shard {s} overlaps predecessor"
            prev_hi = int(self.bounds[s]) if s < len(self.bounds) else prev_hi


def partition_bulkload(keys: np.ndarray, payloads: np.ndarray,
                       num_shards: int,
                       cfg: Optional[AulidConfig] = None,
                       dev_factory: Optional[Callable[[], BlockDevice]] = None,
                       ) -> RangePartition:
    """Bulkload sorted ``keys`` into ``num_shards`` range shards.

    Boundaries are key quantiles: shard ``s`` takes the s-th of S equal-count
    contiguous chunks, and ``bounds[s]`` is its last (largest) key.  Duplicate
    quantile keys collapse (a key is never split across shards), so the
    effective shard count can shrink on heavily duplicated inputs.
    """
    keys = np.asarray(keys, dtype=np.uint64)
    payloads = np.asarray(payloads, dtype=np.uint64)
    assert keys.ndim == 1 and keys.shape == payloads.shape
    assert np.all(keys[1:] >= keys[:-1]), "partition bulkload requires sorted keys"
    n = len(keys)
    num_shards = max(1, int(num_shards))

    def mk() -> Aulid:
        dev = dev_factory() if dev_factory is not None else BlockDevice(
            block_bytes=(cfg.block_bytes if cfg is not None else 4096))
        return Aulid(dev, cfg=cfg)

    if n == 0 or num_shards == 1:
        sh = mk()
        sh.bulkload(keys, payloads)
        return RangePartition(np.empty(0, dtype=np.uint64), [sh])

    # quantile split points; side="right" keeps equal keys in one shard
    cuts = [int(np.searchsorted(
        keys, keys[max((s + 1) * n // num_shards - 1, 0)], side="right"))
        for s in range(num_shards - 1)]
    cuts = sorted(set(c for c in cuts if 0 < c < n))
    bounds = np.array([keys[c - 1] for c in cuts], dtype=np.uint64)
    edges = [0] + cuts + [n]
    shards = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        sh = mk()
        sh.bulkload(keys[lo:hi], payloads[lo:hi])
        shards.append(sh)
    return RangePartition(bounds, shards)
