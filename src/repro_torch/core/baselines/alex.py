# Copied from src/repro/core/baselines/alex.py (the port keeps its own copy).
"""On-disk ALEX [4]: model-based inserts into gapped arrays.

Faithful I/O behaviour per the paper's observations:
* data nodes are *gapped arrays* spanning multiple blocks, with a bitmap
  (header block) marking occupied slots — scans pay extra reads for it
  (paper §5.2.2);
* lookups use model prediction + exponential search, paying extra block
  reads when the search crosses block boundaries;
* inserts shift items toward the nearest gap (writes for every touched
  block), persist node stats in the header (the large Stats cost of
  Fig 1(d)), and expansion SMOs rewrite the whole data node (the large SMO
  cost of Fig 1(d));
* inner nodes route with a linear model (no search).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

from ..blockdev import BlockDevice
from ..interface import OrderedIndex

DATA_PER_BLOCK = 256
MAX_NODE_KEYS = 4096       # data node capacity cap (16 blocks)
MIN_CAP = 256
DENSITY_INIT = 0.7
DENSITY_MAX = 0.8
FANOUT = 64
EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)


class _Model:
    __slots__ = ("slope", "intercept")

    def __init__(self, slope: float, intercept: float):
        self.slope = slope
        self.intercept = intercept

    @staticmethod
    def fit(keys: np.ndarray, out_range: int) -> "_Model":
        """Map [min,max] keys onto [0, out_range)."""
        if len(keys) == 0:
            return _Model(0.0, 0.0)
        kf = keys.astype(np.float64)
        span = kf[-1] - kf[0]
        if span <= 0:
            return _Model(0.0, out_range / 2)
        s = (out_range - 1) / span
        return _Model(s, -s * kf[0])

    def predict(self, key: int, hi: int) -> int:
        return min(max(int(self.slope * float(key) + self.intercept), 0), hi - 1)


class _DataNode:
    __slots__ = ("cap", "keys", "vals", "model", "count", "blocks",
                 "header_block", "next", "prev")

    def __init__(self, dev: BlockDevice, keys: np.ndarray, vals: np.ndarray):
        n = len(keys)
        cap = MIN_CAP
        while cap * DENSITY_INIT < max(n, 1):
            cap *= 2
        self.cap = cap
        self.keys = np.full(cap, EMPTY, dtype=np.uint64)
        self.vals = np.zeros(cap, dtype=np.uint64)
        self.model = _Model.fit(keys, cap)
        self.count = n
        # model-based placement, order-preserving: slot_i is the prediction
        # pushed up to stay strictly increasing and clamped so the remaining
        # n-1-i keys always fit to the right (cap >= n guarantees feasibility)
        prev = -1
        for i in range(n):
            p = max(self.model.predict(int(keys[i]), cap), prev + 1)
            p = min(p, cap - n + i)
            self.keys[p] = keys[i]
            self.vals[p] = vals[i]
            prev = p
        self.header_block = dev.alloc()   # stats + bitmap
        self.blocks = [dev.alloc() for _ in range(cap // DATA_PER_BLOCK)]
        dev.write(self.header_block)
        for b in self.blocks:
            dev.write(b)
        self.next: Optional["_DataNode"] = None
        self.prev: Optional["_DataNode"] = None

    def free(self, dev: BlockDevice) -> None:
        dev.free(self.header_block)
        for b in self.blocks:
            dev.free(b)

    def occupied(self) -> np.ndarray:
        return self.keys != EMPTY

    def sorted_items(self) -> tuple[np.ndarray, np.ndarray]:
        m = self.occupied()
        return self.keys[m], self.vals[m]

    def min_key(self) -> int:
        m = self.occupied()
        return int(self.keys[m][0]) if m.any() else 0


class _InnerNode:
    __slots__ = ("model", "children", "block")

    def __init__(self, dev: BlockDevice, model: _Model, children: list):
        self.model = model
        self.children = children
        self.block = dev.alloc()
        dev.write(self.block)


class AlexIndex(OrderedIndex):
    name = "alex"

    def __init__(self, dev: Optional[BlockDevice] = None, **kw):
        super().__init__(dev)
        self.root: Union[_InnerNode, _DataNode, None] = None
        self.first_data: Optional[_DataNode] = None
        self.n_items = 0
        self.smo_expands = 0

    # ------------------------------------------------------------- bulkload
    def bulkload(self, keys: np.ndarray, payloads: np.ndarray) -> None:
        keys = np.asarray(keys, dtype=np.uint64)
        payloads = np.asarray(payloads, dtype=np.uint64)
        self.n_items = len(keys)
        self.root = self._build(keys, payloads)
        # link data nodes for scans (host-side bookkeeping)
        leaves: list[_DataNode] = []

        def collect(node):
            if isinstance(node, _DataNode):
                if not leaves or leaves[-1] is not node:
                    leaves.append(node)
            else:
                for c in node.children:
                    collect(c)

        collect(self.root)
        uniq: list[_DataNode] = []
        for d in leaves:
            if not uniq or uniq[-1] is not d:
                uniq.append(d)
        for a, b in zip(uniq, uniq[1:]):
            a.next = b
            b.prev = a
        self.first_data = uniq[0] if uniq else None

    def _build(self, keys: np.ndarray, vals: np.ndarray):
        if len(keys) <= MAX_NODE_KEYS:
            return _DataNode(self.dev, keys, vals)
        model = _Model.fit(keys, FANOUT)
        buckets = np.clip((model.slope * keys.astype(np.float64) + model.intercept)
                          .astype(np.int64), 0, FANOUT - 1)
        children = []
        prev_child = None
        for f in range(FANOUT):
            sel = buckets == f
            if not sel.any():
                children.append(prev_child)  # duplicate pointer (ALEX-style)
                continue
            child = self._build(keys[sel], vals[sel])
            children.append(child)
            prev_child = child
        # leading Nones -> point at first real child
        first = next(c for c in children if c is not None)
        children = [first if c is None else c for c in children]
        return _InnerNode(self.dev, model, children)

    # --------------------------------------------------------------- lookup
    def _find_data(self, key: int) -> _DataNode:
        node = self.root
        self.dev.read(node.block if isinstance(node, _InnerNode) else node.header_block)
        while isinstance(node, _InnerNode):
            child = node.children[node.model.predict(key, len(node.children))]
            self.dev.read(child.block if isinstance(child, _InnerNode)
                          else child.header_block)
            node = child
        return node

    def _exp_search(self, d: _DataNode, key: int) -> int:
        """Exponential search around the model prediction; counts the extra
        block reads ALEX pays when the error crosses block boundaries.
        Returns the slot of ``key`` or -1."""
        cap = d.cap
        p = d.model.predict(key, cap)
        self.dev.read(d.blocks[p // DATA_PER_BLOCK])
        blocks_read = {p // DATA_PER_BLOCK}
        # widen exponentially until bracketed, over the *sorted view* semantics
        step = 16
        lo, hi = p, p
        while True:
            lo = max(p - step, 0)
            hi = min(p + step, cap - 1)
            lo_key = self._slot_key_at_or_after(d, lo)
            hi_key = self._slot_key_at_or_before(d, hi)
            if ((lo == 0 or (lo_key is not None and lo_key <= key))
                    and (hi == cap - 1 or (hi_key is not None and hi_key >= key))):
                break
            if lo == 0 and hi == cap - 1:
                break
            step *= 4
        for b in range(lo // DATA_PER_BLOCK, hi // DATA_PER_BLOCK + 1):
            if b not in blocks_read:
                self.dev.read(d.blocks[b])
                blocks_read.add(b)
        window = d.keys[lo : hi + 1]
        idx = np.nonzero(window == np.uint64(key))[0]
        if idx.size:
            return int(lo + idx[0])
        # robustness fallback: scan the rest of the node (pay the block reads)
        idx = np.nonzero(d.keys == np.uint64(key))[0]
        if idx.size:
            b = int(idx[0]) // DATA_PER_BLOCK
            if b not in blocks_read:
                self.dev.read(d.blocks[b])
            return int(idx[0])
        return -1

    @staticmethod
    def _slot_key_at_or_after(d: _DataNode, i: int) -> Optional[int]:
        m = np.nonzero(d.keys[i:] != EMPTY)[0]
        return int(d.keys[i + m[0]]) if m.size else None

    @staticmethod
    def _slot_key_at_or_before(d: _DataNode, i: int) -> Optional[int]:
        m = np.nonzero(d.keys[: i + 1] != EMPTY)[0]
        return int(d.keys[m[-1]]) if m.size else None

    def lookup(self, key: int) -> Optional[int]:
        if self.root is None:
            return None
        d = self._find_data(int(key))
        i = self._exp_search(d, int(key))
        return int(d.vals[i]) if i >= 0 else None

    def scan(self, start_key: int, count: int) -> list[tuple[int, int]]:
        if self.root is None:
            return []
        start_key = int(start_key)
        d = self._find_data(start_key)
        out: list[tuple[int, int]] = []
        first = True
        while d is not None and len(out) < count:
            if not first:
                self.dev.read(d.header_block)  # bitmap read (paper §5.2.2)
            ks, vs = d.sorted_items()
            i = int(np.searchsorted(ks, np.uint64(start_key), side="left")) if first else 0
            # data blocks covering the scanned occupied region
            occ = np.nonzero(d.occupied())[0]
            need = occ[i : i + (count - len(out))]
            for b in sorted({int(s) // DATA_PER_BLOCK for s in need}):
                self.dev.read(d.blocks[b])
            out.extend(zip(ks[i:].tolist(), vs[i:].tolist()))
            first = False
            d = d.next
        return out[:count]

    # --------------------------------------------------------------- insert
    def insert(self, key: int, payload: int) -> None:
        key = int(key)
        if self.root is None:
            self.bulkload(np.array([key], dtype=np.uint64),
                          np.array([payload], dtype=np.uint64))
            return
        d = self._find_data(key)
        cap = d.cap
        p = d.model.predict(key, cap)
        self.dev.read(d.blocks[p // DATA_PER_BLOCK])
        # find insertion point preserving order: first slot whose key > key
        # starting from prediction, then shift toward the nearest gap
        ins = self._ordered_slot(d, key, p)
        gap = self._nearest_gap(d, ins)
        if gap < 0:  # full node (shouldn't happen before density trigger)
            self._expand(d)
            self.insert(key, payload)
            self.n_items -= 1
            return
        if gap < ins:  # shift [gap+1, ins-1] left; key lands at ins-1
            ins -= 1
            d.keys[gap:ins] = d.keys[gap + 1 : ins + 1]
            d.vals[gap:ins] = d.vals[gap + 1 : ins + 1]
        else:          # shift [ins, gap-1] right; key lands at ins
            d.keys[ins + 1 : gap + 1] = d.keys[ins:gap]
            d.vals[ins + 1 : gap + 1] = d.vals[ins:gap]
        lo, hi = (gap, ins) if gap <= ins else (ins, gap)
        d.keys[ins] = key
        d.vals[ins] = payload
        d.count += 1
        self.n_items += 1
        for b in range(lo // DATA_PER_BLOCK, hi // DATA_PER_BLOCK + 1):
            self.dev.write(d.blocks[b])       # every shifted block is rewritten
        self.dev.write(d.header_block)        # stats + bitmap update (Fig 1d)
        if d.count >= DENSITY_MAX * d.cap:
            self._expand(d)

    def _ordered_slot(self, d: _DataNode, key: int, p: int) -> int:
        """Slot index where ``key`` belongs in gapped order."""
        kprev = self._slot_key_at_or_before(d, p)
        if kprev is not None and kprev > key:
            m = np.nonzero((d.keys[: p + 1] != EMPTY)
                           & (d.keys[: p + 1] <= np.uint64(key)))[0]
            return int(m[-1]) + 1 if m.size else 0
        sub = d.keys[p:]
        m = np.nonzero((sub != EMPTY) & (sub < np.uint64(key)))[0]
        return p + (int(m[-1]) + 1 if m.size else 0)

    @staticmethod
    def _nearest_gap(d: _DataNode, ins: int) -> int:
        free = d.keys == EMPTY
        left = np.nonzero(free[:ins])[0]
        right = np.nonzero(free[ins:])[0]
        cl = int(left[-1]) if left.size else -1
        cr = ins + int(right[0]) if right.size else -1
        if cl < 0:
            return cr
        if cr < 0:
            return cl
        return cl if ins - cl <= cr - ins else cr

    def _expand(self, d: _DataNode) -> None:
        """ALEX expansion SMO: retrain the model and rewrite the whole node."""
        self.smo_expands += 1
        ks, vs = d.sorted_items()
        for b in d.blocks:
            self.dev.read(b)
        nd = _DataNode(self.dev, ks, vs)
        nd.next, nd.prev = d.next, d.prev
        if d.prev is not None:
            d.prev.next = nd
        if d.next is not None:
            d.next.prev = nd
        if self.first_data is d:
            self.first_data = nd
        self._replace_child(self.root, d, nd)
        d.free(self.dev)

    def _replace_child(self, node, old, new) -> bool:
        if node is old:
            self.root = new
            return True
        if isinstance(node, _InnerNode):
            hit = False
            for i, c in enumerate(node.children):
                if c is old:
                    node.children[i] = new
                    hit = True
                elif isinstance(c, _InnerNode) and self._replace_child(c, old, new):
                    hit = True
            if hit and isinstance(node, _InnerNode):
                self.dev.write(node.block)
            return hit
        return False

    def delete(self, key: int) -> bool:
        key = int(key)
        if self.root is None:
            return False
        d = self._find_data(key)
        i = self._exp_search(d, key)
        if i < 0:
            return False
        d.keys[i] = EMPTY
        d.count -= 1
        self.n_items -= 1
        self.dev.write(d.blocks[i // DATA_PER_BLOCK])
        self.dev.write(d.header_block)
        return True

    def update(self, key: int, payload: int) -> bool:
        key = int(key)
        if self.root is None:
            return False
        d = self._find_data(key)
        i = self._exp_search(d, key)
        if i < 0:
            return False
        d.vals[i] = payload
        self.dev.write(d.blocks[i // DATA_PER_BLOCK])
        return True
