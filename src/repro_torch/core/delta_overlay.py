# Copied from src/repro/core/delta_overlay.py (the port keeps its own copy).
"""Device-resident sorted delta overlay over a frozen :class:`DeviceIndex`.

The device mirror (``device_index.py``) is an immutable snapshot: before this
subsystem, a single host insert invalidated the whole mirror and forced an
O(n) rebuild before the next batched lookup.  The overlay decouples update
cost from mirror rebuilds (DESIGN.md §3): writes since the last snapshot are
absorbed into a small sorted (key, payload, tombstone) array that the batched
read path merge-consults — an overlay hit wins over the snapshot, a tombstone
hides the key, and scans two-way-merge the leaf chain with the overlay range.

The overlay is folded back into a fresh snapshot only when it grows past
``gamma * n`` (the engine's compaction policy — the same shape as AULID's own
Adjust criterion, paper §4.4: amortize structural work against a fraction of
the data it covers).

Semantics are those of a unique-key ordered map (the serving engine applies
upserts; AULID's duplicate-key multiset is exercised by the host-path tests):

* ``record_insert``/``record_update`` — upsert; clears any tombstone;
* ``record_delete`` — tombstone; hides the key whether it lives in the
  snapshot, the overlay, or both.

Host mutation is dict-based (O(1) per write); the sorted, padded device
arrays are materialized lazily per engine step and cached until dirtied.
Padded capacity grows geometrically so jitted consumers see few shapes.

Write batching (DESIGN.md §14): every mutation also lands in a small
*pending* buffer — the writes since the last device sync.  ``take_batch``
drains it as one sorted (keys, payloads, tombstones) triple, which is all
the serving engines ship to the device per step (O(batch) H2D; the
device-resident pack absorbs it via the overlay-merge kernel).  The sorted
host mirror is maintained *incrementally* from the same buffer
(``np.searchsorted`` + insert of the sorted batch), so ``arrays()`` — the
fallback/reseed path — costs O(n + batch log batch) per dirty step instead
of the O(n log n) full ``argsort`` it used to pay.
"""
from __future__ import annotations

import itertools
from typing import Iterable, Optional

import numpy as np

UINT64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
MIN_CAPACITY = 64

# process-wide monotonic overlay identity: unlike ``id()``, a uid is never
# recycled after garbage collection, so (uid, version) pairs are safe cache
# keys for derived artifacts (merged device packs, operand packs)
_OVERLAY_UIDS = itertools.count(1)


def next_pow2(x: int | float) -> int:
    """Smallest power of two >= max(x, 1) — the shared shape-bucketing
    helper of the overlay, the stacked mirror pads, and the serving
    engines' query/scan buckets."""
    p = 1
    while p < x:
        p <<= 1
    return p


class DeltaOverlay:
    """Sorted write-absorbing overlay merged into batched device reads.

    ``min_capacity`` floors the padded device capacity: sizing it near the
    compaction threshold (``gamma * n``) keeps the jit shape of the merged
    read path constant for the overlay's whole lifetime (one compile).
    """

    __slots__ = ("_map", "_cache", "_min_cap", "_pending", "_sorted",
                 "n_upserts", "n_tombstones", "uid", "version")

    def __init__(self, min_capacity: int = MIN_CAPACITY) -> None:
        self._map: dict[int, tuple[int, bool]] = {}  # key -> (payload, tomb)
        self._cache: Optional[dict[str, np.ndarray]] = None
        self._min_cap = max(int(min_capacity), 1)
        # writes since the last drain (take_batch/mark_synced) — the O(batch)
        # delta the engines ship to the device-resident pack each step
        self._pending: dict[int, tuple[int, bool]] = {}
        # unpadded sorted mirror of (_map minus _pending); None after
        # merge_under, forcing one full rebuild on the rare abort path
        self._sorted: Optional[tuple[np.ndarray, np.ndarray, np.ndarray]] = (
            np.empty(0, np.uint64), np.empty(0, np.uint64), np.empty(0, bool))
        self.n_upserts = 0
        self.n_tombstones = 0
        self.uid = next(_OVERLAY_UIDS)   # never-recycled identity (module doc)
        self.version = 0                 # bumped on every mutation

    @classmethod
    def for_threshold(cls, threshold: float) -> "DeltaOverlay":
        """Overlay whose capacity floor covers a compaction threshold (e.g.
        ``gamma * n``) — the jitted read path then compiles once per
        snapshot instead of once per capacity doubling."""
        return cls(min_capacity=max(MIN_CAPACITY, next_pow2(threshold)))

    @property
    def min_capacity(self) -> int:
        return self._min_cap

    def spawn_empty(self) -> "DeltaOverlay":
        """A fresh empty overlay with the same capacity floor — the
        post-freeze write target of the double-buffered compaction lifecycle
        (DESIGN.md §11): the frozen overlay keeps serving reads while the
        spawned one absorbs writes racing the background rebuild."""
        return DeltaOverlay(min_capacity=self._min_cap)

    # ------------------------------------------------------------- mutation
    def record_insert(self, key: int, payload: int) -> None:
        ent = (int(payload), False)
        self._map[int(key)] = ent
        self._pending[int(key)] = ent
        self._cache = None
        self.version += 1
        self.n_upserts += 1

    record_update = record_insert

    def record_delete(self, key: int) -> None:
        self._map[int(key)] = (0, True)
        self._pending[int(key)] = (0, True)
        self._cache = None
        self.version += 1
        self.n_tombstones += 1

    def clear(self) -> None:
        """Drop all entries (after a compaction folded them into a snapshot).

        A cleared overlay is semantically a FRESH overlay, so it takes a
        fresh uid: consumers that seeded device state from the old contents
        (the merged device pack, DESIGN.md §14) key on uid and must observe
        a structural change here, not just a version bump — otherwise the
        pre-compaction entries would silently survive on device."""
        self._map.clear()
        self._pending.clear()
        self._sorted = (np.empty(0, np.uint64), np.empty(0, np.uint64),
                        np.empty(0, bool))
        self._cache = None
        self.uid = next(_OVERLAY_UIDS)
        self.version += 1

    def merge_under(self, other: "DeltaOverlay") -> None:
        """Fold ``other``'s entries UNDER this overlay's (per-key, this
        overlay wins) — the abort path of a failed background build
        (DESIGN.md §12): the frozen overlay's entries must stay visible over
        the still-live old snapshot, while post-freeze writes keep winning."""
        for key, ent in other._map.items():
            self._map.setdefault(key, ent)
        self._cache = None
        self._sorted = None    # bulk graft: one full rebuild (rare abort path)
        self.version += 1

    # ------------------------------------------------------- write batching
    @property
    def pending_writes(self) -> int:
        """Writes recorded since the last ``take_batch``/``mark_synced``."""
        return len(self._pending)

    def take_batch(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Drain the pending buffer as one sorted, unpadded
        (keys, payloads, tombstones) triple — the step's O(batch) upload for
        the device-resident overlay merge (DESIGN.md §14).

        Draining also folds the batch into the incremental sorted mirror, so
        ``arrays()`` stays consistent whichever path (device merge or host
        reseed) consumes the writes."""
        n = len(self._pending)
        if n == 0:
            return (np.empty(0, np.uint64), np.empty(0, np.uint64),
                    np.empty(0, bool))
        items = sorted(self._pending.items())
        bk = np.fromiter((k for k, _ in items), dtype=np.uint64, count=n)
        bp = np.fromiter((v[0] for _, v in items), dtype=np.uint64, count=n)
        bt = np.fromiter((v[1] for _, v in items), dtype=bool, count=n)
        self._pending.clear()
        if self._sorted is None:
            self._rebuild_sorted()       # post-merge_under: one full rebuild
        else:
            self._apply_sorted(bk, bp, bt)
        return bk, bp, bt

    def mark_synced(self) -> None:
        """Discard the pending buffer after a full-state device reseed: the
        consumer just absorbed the entire map, so the delta is moot."""
        self.take_batch()

    def _rebuild_sorted(self) -> None:
        """Full argsort rebuild of the sorted mirror from the map (initial
        state and the merge_under abort path; steady state is incremental)."""
        n = len(self._map)
        uk = np.fromiter(self._map.keys(), dtype=np.uint64, count=n)
        up = np.fromiter((v[0] for v in self._map.values()),
                         dtype=np.uint64, count=n)
        ut = np.fromiter((v[1] for v in self._map.values()),
                         dtype=bool, count=n)
        order = np.argsort(uk)
        self._sorted = (uk[order], up[order], ut[order])

    def _apply_sorted(self, bk: np.ndarray, bp: np.ndarray, bt: np.ndarray
                      ) -> None:
        """Fold a sorted batch into the sorted mirror: overwrite hits in
        place, insert misses at their searchsorted positions — O(n + batch)
        instead of the full O(n log n) re-argsort per dirty step."""
        sk, sp, st = self._sorted
        if sk.size == 0:
            self._sorted = (bk.copy(), bp.copy(), bt.copy())
            return
        pos = np.searchsorted(sk, bk)
        hit = (pos < sk.size) & (sk[np.minimum(pos, sk.size - 1)] == bk)
        if hit.any():
            sp[pos[hit]] = bp[hit]
            st[pos[hit]] = bt[hit]
        if not hit.all():
            new = ~hit
            # np.insert with an index array interprets positions w.r.t. the
            # ORIGINAL array — exactly what searchsorted produced
            sk = np.insert(sk, pos[new], bk[new])
            sp = np.insert(sp, pos[new], bp[new])
            st = np.insert(st, pos[new], bt[new])
        self._sorted = (sk, sp, st)

    def _sync_sorted(self) -> None:
        if self._pending:
            self.take_batch()
        elif self._sorted is None:
            self._rebuild_sorted()

    # ---------------------------------------------------------------- reads
    def __len__(self) -> int:
        return len(self._map)

    def __contains__(self, key: int) -> bool:
        return int(key) in self._map

    def get(self, key: int) -> Optional[tuple[int, bool]]:
        """(payload, tombstone) for an overlaid key, else None."""
        return self._map.get(int(key))

    def live_items(self) -> Iterable[tuple[int, int]]:
        """Sorted (key, payload) pairs that are not tombstones."""
        for k in sorted(self._map):
            pay, tomb = self._map[k]
            if not tomb:
                yield k, pay

    def range_items(self, start_key: int) -> list[tuple[int, int, bool]]:
        """Sorted (key, payload, tomb) with key >= start_key (host merge twin)."""
        return [(k, *self._map[k]) for k in sorted(self._map)
                if k >= int(start_key)]

    # --------------------------------------------------------- device arrays
    @property
    def capacity(self) -> int:
        """Padded device capacity: next power of two >= len (few jit shapes)."""
        cap = self._min_cap
        while cap < len(self._map):
            cap <<= 1
        return cap

    def arrays(self) -> dict[str, np.ndarray]:
        """Sorted, padded pools for the device merge path (``lookup.py``).

        ``ov_keys`` is UINT64_MAX-padded so the whole-array compare used for
        probing (the ``leaf_search`` idiom) never counts padding AND padding
        doubles as the occupancy mask; real keys must therefore be
        < 2**64-1 (also required by the leaf pools).
        """
        if self._cache is None:
            self._sync_sorted()
            sk, sp, st = self._sorted
            cap = self.capacity
            keys = np.full(cap, UINT64_MAX, dtype=np.uint64)
            pays = np.zeros(cap, dtype=np.uint64)
            tomb = np.zeros(cap, dtype=bool)
            n = sk.size
            if n:
                keys[:n] = sk
                pays[:n] = sp
                tomb[:n] = st
            self._cache = {"ov_keys": keys, "ov_pay": pays, "ov_tomb": tomb}
        return self._cache


def merge_overlays(frozen: Optional["DeltaOverlay"], live: "DeltaOverlay"
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Unpadded sorted (keys, payloads, tombstones) of ``frozen`` updated by
    ``live`` — the read view of a shard whose compaction is in flight
    (DESIGN.md §11): the frozen overlay's entries (including tombstones that
    hide old-snapshot keys) stay visible until the epoch swap retires them,
    while any post-freeze write to the same key wins.

    ``frozen=None`` degrades to the live overlay alone, so pack builders can
    call this unconditionally."""
    if frozen is None or not len(frozen):
        merged = live._map
    else:
        merged = {**frozen._map, **live._map}   # live wins per key
    n = len(merged)
    keys = np.fromiter(merged.keys(), dtype=np.uint64, count=n)
    pays = np.fromiter((v[0] for v in merged.values()), dtype=np.uint64,
                       count=n)
    tomb = np.fromiter((v[1] for v in merged.values()), dtype=bool, count=n)
    order = np.argsort(keys)
    return keys[order], pays[order], tomb[order]
