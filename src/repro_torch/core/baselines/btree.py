# Copied from src/repro/core/baselines/btree.py (the port keeps its own copy).
"""Standard on-disk B+-tree (the paper's primary yardstick).

Inner nodes: one block each, up to 255 (routing key, child block) pairs.
Leaf nodes: one block each, up to 256 (key, payload) pairs + sibling links.
Lookups read exactly one block per level (root included — the paper's
Fig 1(c) counts 4 blocks for a 4-level tree). Only the root address lives in
memory.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..blockdev import BlockDevice
from ..interface import OrderedIndex

LEAF_CAP = 256
INNER_CAP = 255


class _Node:
    __slots__ = ("block", "leaf", "keys", "vals", "count", "next", "prev", "children")

    def __init__(self, dev: BlockDevice, leaf: bool):
        self.block = dev.alloc()
        self.leaf = leaf
        cap = LEAF_CAP if leaf else INNER_CAP
        self.keys = np.zeros(cap, dtype=np.uint64)
        self.vals = np.zeros(cap, dtype=np.uint64) if leaf else None
        self.children: Optional[list] = None if leaf else []
        self.count = 0
        self.next: Optional["_Node"] = None
        self.prev: Optional["_Node"] = None


class BPlusTree(OrderedIndex):
    name = "btree"

    def __init__(self, dev: Optional[BlockDevice] = None, leaf_fill: float = 1.0, **kw):
        super().__init__(dev)
        self.root: Optional[_Node] = None
        self.first_leaf: Optional[_Node] = None
        self.height = 0
        self.leaf_fill = leaf_fill
        self.n_items = 0
        self.smo_splits = 0

    # ------------------------------------------------------------- bulkload
    def bulkload(self, keys: np.ndarray, payloads: np.ndarray) -> None:
        keys = np.asarray(keys, dtype=np.uint64)
        payloads = np.asarray(payloads, dtype=np.uint64)
        n = len(keys)
        self.n_items = n
        fill = max(1, int(LEAF_CAP * self.leaf_fill))
        leaves: list[_Node] = []
        prev = None
        for lo in range(0, max(n, 1), fill):
            node = _Node(self.dev, leaf=True)
            hi = min(lo + fill, n)
            node.keys[: hi - lo] = keys[lo:hi]
            node.vals[: hi - lo] = payloads[lo:hi]
            node.count = hi - lo
            node.prev = prev
            if prev is not None:
                prev.next = node
            self.dev.write(node.block)
            leaves.append(node)
            prev = node
        self.first_leaf = leaves[0]
        level = leaves
        self.height = 1
        while len(level) > 1:
            up: list[_Node] = []
            for lo in range(0, len(level), INNER_CAP):
                node = _Node(self.dev, leaf=False)
                group = level[lo : lo + INNER_CAP]
                for c in group:
                    node.keys[node.count] = self._max_key(c)
                    node.children.append(c)
                    node.count += 1
                self.dev.write(node.block)
                up.append(node)
            level = up
            self.height += 1
        self.root = level[0]

    def _max_key(self, node: _Node) -> int:
        if node.leaf:
            return int(node.keys[node.count - 1]) if node.count else 0
        return int(node.keys[node.count - 1])

    # --------------------------------------------------------------- lookup
    def _find_leaf(self, key: int, path: Optional[list] = None) -> _Node:
        node = self.root
        self.dev.read(node.block)
        while not node.leaf:
            i = int(np.searchsorted(node.keys[: node.count], np.uint64(key), side="left"))
            i = min(i, node.count - 1)
            if path is not None:
                path.append((node, i))
            node = node.children[i]
            self.dev.read(node.block)
        return node

    def lookup(self, key: int) -> Optional[int]:
        key = int(key)
        if self.root is None:
            return None
        leaf = self._find_leaf(key)
        i = int(np.searchsorted(leaf.keys[: leaf.count], np.uint64(key), side="left"))
        if i < leaf.count and int(leaf.keys[i]) == key:
            return int(leaf.vals[i])
        return None

    def scan(self, start_key: int, count: int) -> list[tuple[int, int]]:
        start_key = int(start_key)
        out: list[tuple[int, int]] = []
        if self.root is None:
            return out
        leaf = self._find_leaf(start_key)
        i = int(np.searchsorted(leaf.keys[: leaf.count], np.uint64(start_key), side="left"))
        while leaf is not None and len(out) < count:
            take = min(count - len(out), leaf.count - i)
            if take > 0:
                out.extend(zip(leaf.keys[i : i + take].tolist(),
                               leaf.vals[i : i + take].tolist()))
            leaf = leaf.next
            i = 0
            if leaf is not None and len(out) < count:
                self.dev.read(leaf.block)
        return out

    # --------------------------------------------------------------- insert
    def insert(self, key: int, payload: int) -> None:
        key = int(key)
        if self.root is None:
            self.bulkload(np.array([key], dtype=np.uint64),
                          np.array([payload], dtype=np.uint64))
            return
        self.dev.read(self.root.block)
        right = self._rec_insert(self.root, key, payload)
        if right is not None:  # root split
            root = _Node(self.dev, leaf=False)
            root.keys[0] = self._max_key(self.root)
            root.keys[1] = self._max_key(right)
            root.children = [self.root, right]
            root.count = 2
            self.dev.write(root.block)
            self.root = root
            self.height += 1
        self.n_items += 1

    def _rec_insert(self, node: _Node, key: int, payload: int) -> Optional[_Node]:
        """Insert below ``node`` (already read). Returns a new right sibling if
        ``node`` split, else None. Routing keys are kept exact on the path."""
        if node.leaf:
            c = node.count
            if c < LEAF_CAP:
                i = int(np.searchsorted(node.keys[:c], np.uint64(key), side="right"))
                node.keys[i + 1 : c + 1] = node.keys[i:c]
                node.vals[i + 1 : c + 1] = node.vals[i:c]
                node.keys[i] = key
                node.vals[i] = payload
                node.count = c + 1
                self.dev.write(node.block)
                return None
            right = _Node(self.dev, leaf=True)
            half = c // 2
            right.keys[: c - half] = node.keys[half:c]
            right.vals[: c - half] = node.vals[half:c]
            right.count = c - half
            node.count = half
            right.next = node.next
            right.prev = node
            if node.next is not None:
                node.next.prev = right
            node.next = right
            self.smo_splits += 1
            target = node if key <= int(node.keys[half - 1]) else right
            self._rec_insert(target, key, payload)  # cannot split again
            other = right if target is node else node
            self.dev.write(other.block)
            return right
        # inner node
        c = node.count
        i = min(int(np.searchsorted(node.keys[:c], np.uint64(key), side="left")), c - 1)
        child = node.children[i]
        self.dev.read(child.block)
        new_right = self._rec_insert(child, key, payload)
        changed = False
        if int(node.keys[i]) != self._max_key(child):
            node.keys[i] = self._max_key(child)
            changed = True
        if new_right is None:
            if changed:
                self.dev.write(node.block)
            return None
        rkey = self._max_key(new_right)
        if c < INNER_CAP:
            node.keys[i + 2 : c + 1] = node.keys[i + 1 : c]
            node.keys[i + 1] = rkey
            node.children.insert(i + 1, new_right)
            node.count = c + 1
            self.dev.write(node.block)
            return None
        # split this inner node, then place new_right next to child
        rnode = _Node(self.dev, leaf=False)
        half = c // 2
        rnode.keys[: c - half] = node.keys[half:c]
        rnode.children = node.children[half:]
        rnode.count = c - half
        node.count = half
        self.smo_splits += 1
        target, ti = (node, i) if i < half else (rnode, i - half)
        tc = target.count
        target.keys[ti + 2 : tc + 1] = target.keys[ti + 1 : tc]
        target.keys[ti + 1] = rkey
        target.children.insert(ti + 1, new_right)
        target.count = tc + 1
        self.dev.write(node.block)
        self.dev.write(rnode.block)
        return rnode

    def delete(self, key: int) -> bool:
        key = int(key)
        if self.root is None:
            return False
        leaf = self._find_leaf(key)
        c = leaf.count
        i = int(np.searchsorted(leaf.keys[:c], np.uint64(key), side="left"))
        if i >= c or int(leaf.keys[i]) != key:
            return False
        leaf.keys[i : c - 1] = leaf.keys[i + 1 : c]
        leaf.vals[i : c - 1] = leaf.vals[i + 1 : c]
        leaf.count = c - 1
        self.dev.write(leaf.block)
        self.n_items -= 1
        return True

    def update(self, key: int, payload: int) -> bool:
        key = int(key)
        if self.root is None:
            return False
        leaf = self._find_leaf(key)
        i = int(np.searchsorted(leaf.keys[: leaf.count], np.uint64(key), side="left"))
        if i < leaf.count and int(leaf.keys[i]) == key:
            leaf.vals[i] = payload
            self.dev.write(leaf.block)
            return True
        return False
