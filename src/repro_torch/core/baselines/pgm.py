# Copied from src/repro/core/baselines/pgm.py (the port keeps its own copy).
"""On-disk PGM index [7] with LSM-style insert support.

Static structure: eps-bounded segments over the data (streaming corridor,
``core.pla``), recursively indexed until the top level fits one block. Every
level lives on disk (seg entries packed 128/block; data packed 256/block).
A lookup descends one level at a time, reading the 1-2 blocks covering the
+-eps predicted range — PGM's defining I/O pattern.

Dynamic structure: the paper (§5.1.1) notes PGM "supports the insertion
operation via the same mechanism as [1, 3]" — an LSM of static components of
doubling capacity.  Inserts append to component 0 (one block write); overflow
merges the full prefix of components (read + rewrite, the LSM write
amplification), lookups probe components newest-first (the read amplification
the paper observes in W4-W6).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..blockdev import BlockDevice
from ..interface import OrderedIndex
from ..pla import Segment, build_segments

DATA_PER_BLOCK = 256
SEGS_PER_BLOCK = 128
TOMBSTONE = np.uint64(0xFFFFFFFFFFFFFFFF)


class _StaticPGM:
    """One immutable component: data blocks + recursive segment levels."""

    def __init__(self, dev: BlockDevice, keys: np.ndarray, pays: np.ndarray,
                 eps: int):
        self.dev = dev
        self.eps = eps
        self.keys = keys
        self.pays = pays
        n = len(keys)
        self.data_blocks = [dev.alloc() for _ in range(max(1, -(-n // DATA_PER_BLOCK)))]
        for b in self.data_blocks:
            dev.write(b)
        # levels[0] = segments over data; levels[j] = segments over levels[j-1]
        self.levels: list[dict] = []
        arr = keys
        while True:
            segs = build_segments(arr, eps)
            blocks = [dev.alloc() for _ in range(max(1, -(-len(segs) // SEGS_PER_BLOCK)))]
            for b in blocks:
                dev.write(b)
            first_keys = np.array([s.first_key for s in segs], dtype=np.uint64)
            self.levels.append({"segs": segs, "blocks": blocks, "first_keys": first_keys})
            if len(segs) <= SEGS_PER_BLOCK:
                break
            arr = first_keys

    def free(self) -> None:
        for b in self.data_blocks:
            self.dev.free(b)
        for lv in self.levels:
            for b in lv["blocks"]:
                self.dev.free(b)

    @property
    def n(self) -> int:
        return len(self.keys)

    def _read_range_blocks(self, blocks: list[int], lo: int, hi: int, per: int) -> None:
        """Read the block(s) covering element range [lo, hi]."""
        b0, b1 = lo // per, min(hi // per, len(blocks) - 1)
        for b in range(b0, b1 + 1):
            self.dev.read(blocks[b])

    def _locate(self, key: int) -> tuple[int, int]:
        """Descend levels; return (lo, hi) candidate rank range in the data."""
        eps = self.eps
        # top level: one block
        top = self.levels[-1]
        self.dev.read(top["blocks"][0])
        si = max(int(np.searchsorted(top["first_keys"], np.uint64(key), side="right")) - 1, 0)
        for j in range(len(self.levels) - 1, 0, -1):
            seg = self.levels[j]["segs"][si]
            below = self.levels[j - 1]
            pos = seg.start_rank + seg.predict(key)
            lo = max(pos - eps, 0)
            hi = min(pos + eps, len(below["segs"]) - 1)
            self._read_range_blocks(below["blocks"], lo, hi, SEGS_PER_BLOCK)
            fk = below["first_keys"]
            si = max(int(np.searchsorted(fk[lo : hi + 1], np.uint64(key), side="right"))
                     - 1 + lo, 0)
        seg = self.levels[0]["segs"][si]
        pos = seg.start_rank + seg.predict(key)
        lo = max(pos - eps, 0)
        hi = min(pos + eps, self.n - 1)
        self._read_range_blocks(self.data_blocks, lo, hi, DATA_PER_BLOCK)
        return lo, hi

    def lookup(self, key: int) -> Optional[int]:
        if self.n == 0 or key < int(self.keys[0]) or key > int(self.keys[-1]):
            return None
        lo, hi = self._locate(key)
        i = lo + int(np.searchsorted(self.keys[lo : hi + 1], np.uint64(key), side="left"))
        # corridor guarantee is +-eps, but be robust at segment edges
        while i < self.n and int(self.keys[i]) < key:
            if i // DATA_PER_BLOCK != (i + 1) // DATA_PER_BLOCK:
                self.dev.read(self.data_blocks[min((i + 1) // DATA_PER_BLOCK,
                                                   len(self.data_blocks) - 1)])
            i += 1
        if i < self.n and int(self.keys[i]) == key:
            return int(self.pays[i])
        return None

    def scan_from(self, key: int, count: int) -> list[tuple[int, int]]:
        if self.n == 0:
            return []
        if key > int(self.keys[-1]):
            return []
        if key < int(self.keys[0]):
            i = 0
            self.dev.read(self.data_blocks[0])
        else:
            lo, hi = self._locate(key)
            i = lo + int(np.searchsorted(self.keys[lo : hi + 1], np.uint64(key),
                                         side="left"))
        out = []
        last_block = i // DATA_PER_BLOCK
        while i < self.n and len(out) < count:
            b = i // DATA_PER_BLOCK
            if b != last_block:
                self.dev.read(self.data_blocks[b])
                last_block = b
            out.append((int(self.keys[i]), int(self.pays[i])))
            i += 1
        return out


class PGMIndex(OrderedIndex):
    name = "pgm"

    def __init__(self, dev: Optional[BlockDevice] = None, eps: int = 64,
                 c0_capacity: int = DATA_PER_BLOCK, **kw):
        super().__init__(dev)
        self.eps = eps
        self.c0_cap = c0_capacity
        self.c0_keys: list[int] = []
        self.c0_pays: list[int] = []
        self.c0_block = self.dev.alloc()
        self.components: list[Optional[_StaticPGM]] = []  # doubling capacities
        self.n_items = 0
        self.smo_merges = 0

    def bulkload(self, keys: np.ndarray, payloads: np.ndarray) -> None:
        keys = np.asarray(keys, dtype=np.uint64)
        payloads = np.asarray(payloads, dtype=np.uint64)
        self.components = [_StaticPGM(self.dev, keys, payloads, self.eps)]
        self.n_items = len(keys)

    # ------------------------------------------------------------------ reads
    def lookup(self, key: int) -> Optional[int]:
        key = int(key)
        # newest first: C0 buffer (1 block), then components
        if self.c0_keys:
            self.dev.read(self.c0_block)
            for k, p in zip(reversed(self.c0_keys), reversed(self.c0_pays)):
                if k == key:
                    return None if np.uint64(p) == TOMBSTONE else p
        for comp in self.components:
            if comp is None:
                continue
            r = comp.lookup(key)
            if r is not None:
                return None if np.uint64(r) == TOMBSTONE else r
        return None

    def scan(self, start_key: int, count: int) -> list[tuple[int, int]]:
        start_key = int(start_key)
        merged: dict[int, int] = {}
        for comp in reversed([c for c in self.components if c is not None]):
            for k, p in comp.scan_from(start_key, count):
                merged[k] = p
        if self.c0_keys:
            self.dev.read(self.c0_block)
            for k, p in zip(self.c0_keys, self.c0_pays):
                if k >= start_key:
                    merged[k] = p
        out = sorted(merged.items())[:count]
        return [(k, p) for k, p in out if np.uint64(p) != TOMBSTONE]

    # ----------------------------------------------------------------- writes
    def insert(self, key: int, payload: int) -> None:
        self.c0_keys.append(int(key))
        self.c0_pays.append(int(payload))
        self.dev.write(self.c0_block)
        self.n_items += 1
        if len(self.c0_keys) >= self.c0_cap:
            self._merge()

    def delete(self, key: int) -> bool:
        # LSM delete = tombstone insert
        if self.lookup(key) is None:
            return False
        self.insert(int(key), int(TOMBSTONE))
        self.n_items -= 2  # insert() counted one up; the pair nets to -1
        return True

    def update(self, key: int, payload: int) -> bool:
        if self.lookup(key) is None:
            return False
        self.insert(int(key), int(payload))
        self.n_items -= 1
        return True

    def _merge(self) -> None:
        """Merge C0 + the full prefix of components into one larger component."""
        self.smo_merges += 1
        order = np.argsort(np.array(self.c0_keys, dtype=np.uint64), stable=True)
        keys = np.array(self.c0_keys, dtype=np.uint64)[order]
        pays = np.array(self.c0_pays, dtype=np.uint64)[order]
        self.c0_keys, self.c0_pays = [], []
        self.dev.write(self.c0_block)
        level = 0
        while True:
            if level >= len(self.components):
                self.components.append(None)
            comp = self.components[level]
            cap = self.c0_cap * (2 ** (level + 1))
            if comp is None:
                if len(keys):
                    self.components[level] = _StaticPGM(self.dev, keys, pays, self.eps)
                return
            # read the existing component fully (merge I/O), then free it
            for b in comp.data_blocks:
                self.dev.read(b)
            ck, cp = comp.keys, comp.pays
            comp.free()
            self.components[level] = None
            # newest-wins merge on duplicates
            keys2 = np.concatenate([ck, keys])
            pays2 = np.concatenate([cp, pays])
            order = np.argsort(keys2, kind="stable")
            keys2, pays2 = keys2[order], pays2[order]
            last = np.ones(len(keys2), dtype=bool)
            last[:-1] = keys2[1:] != keys2[:-1]
            keys, pays = keys2[last], pays2[last]
            if len(keys) <= cap:
                self.components[level] = _StaticPGM(self.dev, keys, pays, self.eps)
                return
            level += 1
