# Copied from src/repro/core/baselines/lipp.py (the port keeps its own copy).
"""On-disk LIPP [35]: precise-position learned index, FMCD at every level.

LIPP stores key-payload pairs directly in its (large-fanout) nodes, creating
a child node whenever two keys conflict in a slot. On disk this produces the
paper's observations (Figs 1, 5-7):
* lookups are short (few levels — best-in-class fetched blocks for reads),
  but each level fetches the node's header block (model) plus the predicted
  slot's block when they differ — LIPP stores the model at the node start,
  unlike AULID which hoists it into the parent (§3.3.2);
* inserts into occupied slots force node-creation SMOs (the 4.5M SMOs on
  GENOME, §5.2.3) plus on-disk stats updates along the path (Fig 1d);
* scans traverse many nodes (no sibling links, interleaved subtrees):
  24 blocks for a 100-key scan on FB (Fig 1c).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..blockdev import BlockDevice
from ..fmcd import fmcd
from ..interface import OrderedIndex

SLOTS_PER_BLOCK = 256     # 16-byte slots
HEADER_SLOTS = 8          # model + stats live at the node start
T_NULL, T_DATA, T_NODE = 0, 1, 2


class _Node:
    __slots__ = ("fanout", "model", "blocks", "tags", "keys", "vals", "children",
                 "size", "init_size", "conflicts")

    def __init__(self, dev: BlockDevice, keys: np.ndarray, vals: np.ndarray,
                 creates: list[int]):
        n = len(keys)
        self.fanout = max(2 * n, 64)
        self.model, _ = fmcd(keys, self.fanout)
        nblocks = -(-(self.fanout + HEADER_SLOTS) // SLOTS_PER_BLOCK)
        self.blocks = [dev.alloc() for _ in range(nblocks)]
        self.tags = np.zeros(self.fanout, dtype=np.uint8)
        self.keys = np.zeros(self.fanout, dtype=np.uint64)
        self.vals = np.zeros(self.fanout, dtype=np.uint64)
        self.children: dict[int, "_Node"] = {}
        self.size = n
        self.init_size = max(n, 1)
        self.conflicts = 0
        creates[0] += 1
        slots = self.model.predict_clipped(keys, self.fanout)
        uniq, starts = np.unique(slots, return_index=True)
        bounds = list(starts) + [n]
        for gi, slot in enumerate(uniq):
            lo, hi = bounds[gi], bounds[gi + 1]
            slot = int(slot)
            if hi - lo == 1:
                self.tags[slot] = T_DATA
                self.keys[slot] = keys[lo]
                self.vals[slot] = vals[lo]
            else:
                # duplicates, or keys denser than float64 resolution (no
                # progress possible): store as a degenerate chain node
                if len(np.unique(keys[lo:hi])) == 1 or hi - lo == n:
                    # duplicate keys: LIPP chains (linked list in memory —
                    # here a degenerate child holding them at distinct slots)
                    sub_k, sub_v = keys[lo:hi], vals[lo:hi]
                    child = _Node.__new__(_Node)
                    child.fanout = len(sub_k)
                    child.model, _ = fmcd(sub_k[:1], 2)
                    child.blocks = [dev.alloc()]
                    child.tags = np.full(len(sub_k), T_DATA, dtype=np.uint8)
                    child.keys = sub_k.copy()
                    child.vals = sub_v.copy()
                    child.children = {}
                    child.size = len(sub_k)
                    child.init_size = len(sub_k)
                    child.conflicts = 0
                    dev.write(child.blocks[0])
                else:
                    child = _Node(dev, keys[lo:hi], vals[lo:hi], creates)
                self.tags[slot] = T_NODE
                self.children[slot] = child
        for b in self.blocks:
            dev.write(b)

    def predict(self, key: int) -> int:
        p = int(self.model.slope * float(key) + self.model.intercept)
        return min(max(p, 0), self.fanout - 1)

    def slot_block(self, slot: int) -> int:
        return self.blocks[(slot + HEADER_SLOTS) // SLOTS_PER_BLOCK]

    def read_for(self, dev: BlockDevice, slot: int) -> None:
        """Header block (model) + slot block if different (paper §3.3.2)."""
        dev.read(self.blocks[0])
        sb = self.slot_block(slot)
        if sb != self.blocks[0]:
            dev.read(sb)

    def free(self, dev: BlockDevice) -> None:
        for b in self.blocks:
            dev.free(b)
        for c in self.children.values():
            c.free(dev)


class LippIndex(OrderedIndex):
    name = "lipp"

    def __init__(self, dev: Optional[BlockDevice] = None,
                 adjust_ratio: float = 0.1, **kw):
        super().__init__(dev)
        self.root: Optional[_Node] = None
        self.adjust_ratio = adjust_ratio
        self.n_items = 0
        self.smo_creates = 0
        self.smo_adjusts = 0

    def bulkload(self, keys: np.ndarray, payloads: np.ndarray) -> None:
        keys = np.asarray(keys, dtype=np.uint64)
        payloads = np.asarray(payloads, dtype=np.uint64)
        self.n_items = len(keys)
        if len(keys):
            creates = [0]
            self.root = _Node(self.dev, keys, payloads, creates)

    # --------------------------------------------------------------- lookup
    def lookup(self, key: int) -> Optional[int]:
        key = int(key)
        node = self.root
        while node is not None:
            slot = node.predict(key)
            node.read_for(self.dev, slot)
            tag = int(node.tags[slot])
            if tag == T_NULL:
                return None
            if tag == T_DATA:
                return int(node.vals[slot]) if int(node.keys[slot]) == key else None
            node = node.children[slot]
        return None

    def scan(self, start_key: int, count: int) -> list[tuple[int, int]]:
        """In-order traversal from start_key — LIPP's expensive scan (Fig 1c):
        every visited node costs block reads; subtrees interleave."""
        out: list[tuple[int, int]] = []
        if self.root is None:
            return out

        def walk(node: _Node, lo_slot: int) -> bool:
            self.dev.read(node.blocks[0])
            occ = np.nonzero(node.tags[lo_slot:] != T_NULL)[0]
            last_block = 0
            for s in occ + lo_slot:
                s = int(s)
                sb = node.slot_block(s)
                if sb != node.blocks[0] and sb != last_block:
                    self.dev.read(sb)
                    last_block = sb
                if int(node.tags[s]) == T_DATA:
                    if int(node.keys[s]) >= start_key:
                        out.append((int(node.keys[s]), int(node.vals[s])))
                        if len(out) >= count:
                            return True
                else:
                    child = node.children[s]
                    # prune subtrees entirely below start_key
                    if walk(child, 0):
                        return True
            return False

        start_key = int(start_key)
        node = self.root
        # descend to the start position, then unwind with in-order traversal
        stack: list[tuple[_Node, int]] = []
        while True:
            slot = node.predict(start_key)
            node.read_for(self.dev, slot)
            tag = int(node.tags[slot]) if slot < len(node.tags) else T_NULL
            if tag == T_NODE and slot in node.children:
                stack.append((node, slot))
                node = node.children[slot]
                continue
            stack.append((node, slot))
            break
        done = False
        first = True
        while stack and not done:
            node, slot = stack.pop()
            done = walk(node, slot if first else slot + 1)
            first = False
        return out[:count]

    # --------------------------------------------------------------- insert
    def insert(self, key: int, payload: int) -> None:
        key = int(key)
        if self.root is None:
            self.bulkload(np.array([key], dtype=np.uint64),
                          np.array([payload], dtype=np.uint64))
            return
        path: list[_Node] = []
        node = self.root
        while True:
            path.append(node)
            slot = node.predict(key)
            node.read_for(self.dev, slot)
            tag = int(node.tags[slot])
            if tag == T_NODE:
                node = node.children[slot]
                continue
            if tag == T_NULL:
                node.tags[slot] = T_DATA
                node.keys[slot] = key
                node.vals[slot] = payload
                self.dev.write(node.slot_block(slot))
                break
            # conflict: create a child node holding both keys (LIPP SMO)
            ek, ev = int(node.keys[slot]), int(node.vals[slot])
            ks = np.array(sorted([(ek, ev), (key, payload)]), dtype=np.uint64)
            creates = [0]
            child = _Node(self.dev, ks[:, 0].copy(), ks[:, 1].copy(), creates)
            self.smo_creates += creates[0]
            node.tags[slot] = T_NODE
            node.children[slot] = child
            node.conflicts += 1
            self.dev.write(node.slot_block(slot))
            break
        self.n_items += 1
        # persist per-node stats along the path (header writes, Fig 1d)
        for n in path:
            n.size += 1
            self.dev.write(n.blocks[0])
        self._maybe_adjust(path)

    def _maybe_adjust(self, path: list[_Node]) -> None:
        """LIPP rebuild: subtree grew past 2x and conflict ratio too high."""
        for i, n in enumerate(path):
            if n.size >= 2 * n.init_size and n.conflicts >= self.adjust_ratio * n.size:
                items = self._collect(n)
                ks = np.array([e[0] for e in items], dtype=np.uint64)
                vs = np.array([e[1] for e in items], dtype=np.uint64)
                creates = [0]
                rebuilt = _Node(self.dev, ks, vs, creates)
                self.smo_creates += creates[0]
                self.smo_adjusts += 1
                if i == 0:
                    n.free(self.dev)
                    self.root = rebuilt
                else:
                    parent = path[i - 1]
                    for s, c in parent.children.items():
                        if c is n:
                            parent.children[s] = rebuilt
                            self.dev.write(parent.slot_block(s))
                            break
                    n.free(self.dev)
                break

    def _collect(self, node: _Node) -> list[tuple[int, int]]:
        for b in node.blocks:
            self.dev.read(b)
        out: list[tuple[int, int]] = []
        for s in np.nonzero(node.tags != T_NULL)[0]:
            s = int(s)
            if int(node.tags[s]) == T_DATA:
                out.append((int(node.keys[s]), int(node.vals[s])))
            else:
                out.extend(self._collect(node.children[s]))
        out.sort()
        return out

    def delete(self, key: int) -> bool:
        key = int(key)
        node = self.root
        while node is not None:
            slot = node.predict(key)
            node.read_for(self.dev, slot)
            tag = int(node.tags[slot])
            if tag == T_NULL:
                return False
            if tag == T_DATA:
                if int(node.keys[slot]) != key:
                    return False
                node.tags[slot] = T_NULL
                node.size -= 1
                self.dev.write(node.slot_block(slot))
                self.n_items -= 1
                return True
            node = node.children[slot]
        return False

    def update(self, key: int, payload: int) -> bool:
        key = int(key)
        node = self.root
        while node is not None:
            slot = node.predict(key)
            node.read_for(self.dev, slot)
            tag = int(node.tags[slot])
            if tag == T_NULL:
                return False
            if tag == T_DATA:
                if int(node.keys[slot]) != key:
                    return False
                node.vals[slot] = payload
                self.dev.write(node.slot_block(slot))
                return True
            node = node.children[slot]
        return False
