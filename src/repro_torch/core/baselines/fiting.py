# Copied from src/repro/core/baselines/fiting.py (the port keeps its own copy).
"""On-disk FITing-tree [8] with the Delta Insert Strategy.

Per the paper's setup (§5.1.1): segments come from the same streaming
corridor algorithm as PGM (replacing FITing-tree's greedy partitioning), a
B+-tree indexes segment first-keys, and every segment owns a delta buffer
block for inserts.  A full buffer triggers the FITing-tree SMO: merge the
segment's data with its buffer, re-segment, rewrite — the write amplification
the paper measures in Figs 7/9.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..blockdev import BlockDevice
from ..interface import OrderedIndex
from ..pla import build_segments
from .btree import BPlusTree

DATA_PER_BLOCK = 256
BUFFER_CAP = 256


class _Seg:
    __slots__ = ("first_key", "slope", "keys", "pays", "blocks",
                 "buf_keys", "buf_pays", "buf_block")

    def __init__(self, dev: BlockDevice, first_key: int, slope: float,
                 keys: np.ndarray, pays: np.ndarray):
        self.first_key = first_key
        self.slope = slope
        self.keys = keys
        self.pays = pays
        self.blocks = [dev.alloc() for _ in range(max(1, -(-len(keys) // DATA_PER_BLOCK)))]
        for b in self.blocks:
            dev.write(b)
        self.buf_keys: list[int] = []
        self.buf_pays: list[int] = []
        self.buf_block = dev.alloc()

    def free(self, dev: BlockDevice) -> None:
        for b in self.blocks:
            dev.free(b)
        dev.free(self.buf_block)

    def predict(self, key: int) -> int:
        return int(self.slope * (float(key) - float(self.first_key)))


class FITingTree(OrderedIndex):
    name = "fiting"

    def __init__(self, dev: Optional[BlockDevice] = None, eps: int = 64, **kw):
        super().__init__(dev)
        self.eps = eps
        self.segs: dict[int, _Seg] = {}      # seg id -> segment
        self.inner = BPlusTree(self.dev)     # first_key -> seg id
        self._next_id = 0
        self.n_items = 0
        self.smo_resegment = 0

    # ------------------------------------------------------------- bulkload
    def bulkload(self, keys: np.ndarray, payloads: np.ndarray) -> None:
        keys = np.asarray(keys, dtype=np.uint64)
        payloads = np.asarray(payloads, dtype=np.uint64)
        self.n_items = len(keys)
        pieces = build_segments(keys, self.eps)
        fk, ids = [], []
        for s in pieces:
            seg = _Seg(self.dev, s.first_key, s.slope,
                       keys[s.start_rank : s.start_rank + s.n].copy(),
                       payloads[s.start_rank : s.start_rank + s.n].copy())
            sid = self._next_id
            self._next_id += 1
            self.segs[sid] = seg
            fk.append(s.first_key)
            ids.append(sid)
        self.inner.bulkload(np.array(fk, dtype=np.uint64),
                            np.array(ids, dtype=np.uint64))

    # -------------------------------------------------------------- helpers
    def _find_seg(self, key: int) -> Optional[_Seg]:
        """Predecessor query on the inner B+-tree (reads its path blocks)."""
        if self.inner.root is None:
            return None
        node = self.inner.root
        self.dev.read(node.block)
        while not node.leaf:
            i = int(np.searchsorted(node.keys[: node.count], np.uint64(key), side="left"))
            i = min(i, node.count - 1)
            node = node.children[i]
            self.dev.read(node.block)
        c = node.count
        i = int(np.searchsorted(node.keys[:c], np.uint64(key), side="right")) - 1
        if i < 0:
            if node.prev is None:
                i = 0  # key below the global min: first segment
            else:
                node = node.prev
                self.dev.read(node.block)
                i = node.count - 1
        return self.segs[int(node.vals[i])]

    def _search_seg(self, seg: _Seg, key: int) -> Optional[int]:
        n = len(seg.keys)
        if n:
            pos = min(max(seg.predict(key), 0), n - 1)
            lo = max(pos - self.eps, 0)
            hi = min(pos + self.eps, n - 1)
            b0, b1 = lo // DATA_PER_BLOCK, hi // DATA_PER_BLOCK
            for b in range(b0, b1 + 1):
                self.dev.read(seg.blocks[b])
            i = lo + int(np.searchsorted(seg.keys[lo : hi + 1], np.uint64(key),
                                         side="left"))
            while i < n and int(seg.keys[i]) < key:  # edge robustness
                nb = i // DATA_PER_BLOCK
                i += 1
                if i < n and i // DATA_PER_BLOCK != nb:
                    self.dev.read(seg.blocks[i // DATA_PER_BLOCK])
            if i < n and int(seg.keys[i]) == key:
                return int(seg.pays[i])
        # delta buffer (one block)
        if seg.buf_keys:
            self.dev.read(seg.buf_block)
            for k, p in zip(reversed(seg.buf_keys), reversed(seg.buf_pays)):
                if k == key:
                    return p
        return None

    # ------------------------------------------------------------------ api
    def lookup(self, key: int) -> Optional[int]:
        seg = self._find_seg(int(key))
        return None if seg is None else self._search_seg(seg, int(key))

    def scan(self, start_key: int, count: int) -> list[tuple[int, int]]:
        start_key = int(start_key)
        seg = self._find_seg(start_key)
        if seg is None:
            return []
        out: list[tuple[int, int]] = []
        # iterate segments in key order via the inner tree's leaf chain
        seg_ids = self._segments_from(seg)
        first = True
        for sid in seg_ids:
            s = self.segs[sid]
            merged = list(zip(s.keys.tolist(), s.pays.tolist()))
            if s.buf_keys:
                self.dev.read(s.buf_block)
                merged = sorted(merged + list(zip(s.buf_keys, s.buf_pays)))
            if first:
                i = int(np.searchsorted(np.array([k for k, _ in merged], dtype=np.uint64),
                                        np.uint64(start_key), side="left")) if merged else 0
                merged = merged[i:]
                first = False
                lo_block = (i // DATA_PER_BLOCK) if s.keys.size else 0
            else:
                lo_block = 0
            nblk = max(1, -(-len(merged) // DATA_PER_BLOCK))
            for b in range(lo_block, min(lo_block + -(-max(count - len(out), 0)
                                                      // DATA_PER_BLOCK) + 1, nblk)):
                if b < len(s.blocks):
                    self.dev.read(s.blocks[b])
            out.extend(merged[: count - len(out)])
            if len(out) >= count:
                break
        return out[:count]

    def _segments_from(self, seg: _Seg) -> list[int]:
        """Segment ids in key order starting at ``seg`` (via inner leaf chain)."""
        ids: list[int] = []
        node = self.inner.first_leaf
        started = False
        while node is not None:
            for i in range(node.count):
                sid = int(node.vals[i])
                if self.segs.get(sid) is seg:
                    started = True
                if started:
                    ids.append(sid)
            node = node.next
        return ids

    def insert(self, key: int, payload: int) -> None:
        key = int(key)
        if self.inner.root is None:
            self.bulkload(np.array([key], dtype=np.uint64),
                          np.array([payload], dtype=np.uint64))
            return
        seg = self._find_seg(key)
        self.dev.read(seg.buf_block)
        seg.buf_keys.append(key)
        seg.buf_pays.append(int(payload))
        self.dev.write(seg.buf_block)
        self.n_items += 1
        if len(seg.buf_keys) >= BUFFER_CAP:
            self._resegment(seg)

    def _resegment(self, seg: _Seg) -> None:
        """FITing-tree SMO: merge data+buffer, re-run the corridor, rewrite."""
        self.smo_resegment += 1
        for b in seg.blocks:
            self.dev.read(b)
        keys = np.concatenate([seg.keys, np.array(seg.buf_keys, dtype=np.uint64)])
        pays = np.concatenate([seg.pays, np.array(seg.buf_pays, dtype=np.uint64)])
        order = np.argsort(keys, kind="stable")
        keys, pays = keys[order], pays[order]
        old_first = seg.first_key
        # remove the old entry, free blocks, insert new segments
        sid_old = None
        for sid, s in self.segs.items():
            if s is seg:
                sid_old = sid
                break
        seg.free(self.dev)
        del self.segs[sid_old]
        self.inner.delete(old_first)
        for s in build_segments(keys, self.eps):
            nseg = _Seg(self.dev, s.first_key, s.slope,
                        keys[s.start_rank : s.start_rank + s.n].copy(),
                        pays[s.start_rank : s.start_rank + s.n].copy())
            sid = self._next_id
            self._next_id += 1
            self.segs[sid] = nseg
            self.inner.insert(int(s.first_key), sid)

    def delete(self, key: int) -> bool:
        key = int(key)
        seg = self._find_seg(key)
        if seg is None:
            return False
        i = int(np.searchsorted(seg.keys, np.uint64(key), side="left"))
        if i < len(seg.keys) and int(seg.keys[i]) == key:
            seg.keys = np.delete(seg.keys, i)
            seg.pays = np.delete(seg.pays, i)
            self.dev.write(seg.blocks[min(i // DATA_PER_BLOCK, len(seg.blocks) - 1)])
            self.n_items -= 1
            return True
        if key in seg.buf_keys:
            j = seg.buf_keys.index(key)
            seg.buf_keys.pop(j)
            seg.buf_pays.pop(j)
            self.dev.write(seg.buf_block)
            self.n_items -= 1
            return True
        return False

    def update(self, key: int, payload: int) -> bool:
        key = int(key)
        seg = self._find_seg(key)
        if seg is None:
            return False
        i = int(np.searchsorted(seg.keys, np.uint64(key), side="left"))
        if i < len(seg.keys) and int(seg.keys[i]) == key:
            seg.pays[i] = payload
            self.dev.write(seg.blocks[min(i // DATA_PER_BLOCK, len(seg.blocks) - 1)])
            return True
        return False
