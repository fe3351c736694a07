# Copied from src/repro/core/aulid.py (the port keeps its own copy; it
# also counts its walks: leaf_walks, null_scans, null_scan_slots).
"""AULID — A fully on-disk Updatable Learned Index (host structure).

Faithful implementation of the paper (see DESIGN.md §1):

* **Leaf nodes** (§3.3.3): B+-tree-styled packed blocks (256 key-payload pairs
  per 4 KB block) with sibling links; inner nodes index only each leaf's max key.
* **Inner nodes** (§3.3.2): *mixed* nodes with an FMCD linear model (stored in
  the parent, so each level costs exactly one block fetch) whose slots are
  NULL / DATA / NODE, where NODE points at a fixed-size packed array
  (8/16/32/64 items), a two-layer B+-tree (<=4 children, <=1020 items), or a
  child mixed node.
* **Metanode** (§3.3.1): root address+model and the last leaf's address and
  key range, held in main memory.
* **Operations** (§4): bulkload with the 3-way conflict split, lookup with the
  five slot cases (incl. NULL forward scan), scan via sibling links, insert
  with larger-half-stays-in-place leaf splits, delete, duplicate keys, and the
  ScanFward / Fulfill read optimizations (§4.2.3).
* **Adjust** (§4.4, Algorithm 2): bounded inner height via rebuild when
  ``size >= beta * init_size`` and ``l3_items >= alpha * size``.  The l3
  statistic is computed exactly and cheaply from per-node (size, direct_data)
  aggregates: entries at relative layer >= 3 of node n are exactly
  ``sum(c.size - c.direct_data for mixed children c of n)``.

Structure mutation is host-side Python/NumPy (the paper's single-threaded
setting); batched reads are mirrored to device arrays for the JAX/Pallas
lookup path (``device_index.py`` / ``lookup.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .blockdev import BlockDevice
from .fmcd import LinearModel, fmcd
from .interface import OrderedIndex

# Slot tags (also used by the device mirror).
TAG_NULL = 0
TAG_DATA = 1
TAG_PA = 2      # packed array
TAG_BT = 3      # two-layer B+-tree
TAG_MIXED = 4   # child mixed node


@dataclasses.dataclass(frozen=True)
class JournalEntry:
    """One logical write since the last mirror snapshot (DESIGN.md §3).

    ``leaf`` is the host block id whose content changed — the refresh fast
    path (``device_index.refresh_device_index``) re-mirrors exactly those
    rows instead of re-enumerating the whole tree."""
    op: str          # "insert" | "delete" | "update"
    key: int
    payload: int
    leaf: int


@dataclasses.dataclass
class AulidConfig:
    block_bytes: int = 4096
    leaf_capacity: int = 256            # 16-byte pairs per 4 KB block (paper §3.3.2)
    mixed_slots_per_block: int = 128    # 32 B per mixed slot (model lives in parent)
    pa_classes: tuple[int, ...] = (8, 16, 32, 64)   # 2^{i+2}, i=1..4 (paper §3.3.2)
    bt_max_children: int = 4
    bt_child_capacity: int = 255        # 255*4 + count word = 1020 items max
    alpha: float = 0.05                 # Adjust criterion 1 (paper §4.4.1)
    beta: float = 1.2                   # Adjust criterion 2
    scanfward: bool = True              # read optimization, default on (paper §5.4.1)
    fulfill: bool = False               # read-only optimization, default off
    max_inner_height: int = 3           # Adjust bounds inner mixed-node depth
    leaf_fill: float = 1.0              # bulkload leaf fill factor
    fanout_mult: int = 2                # mixed-node fanout = mult * n_entries
    min_fanout: int = 64
    max_fanout: int = 1 << 22
    lipp_inner: bool = False            # LIPP-B+ ablation (§5.4): resolve every
                                        # inner conflict with a child mixed node
                                        # (no packed arrays / two-layer B+-trees)

    @property
    def pa_threshold(self) -> int:
        return self.pa_classes[-1]       # < 64  -> packed array

    @property
    def bt_threshold(self) -> int:
        return self.bt_max_children * self.bt_child_capacity  # < 1020 -> 2-layer B+-tree


class PackedArray:
    """Fixed-size sorted array of (key, leaf_block) pairs; one block on disk."""

    __slots__ = ("cls_idx", "capacity", "count", "keys", "ptrs", "block")

    def __init__(self, cfg: AulidConfig, dev: BlockDevice, cls_idx: int):
        self.cls_idx = cls_idx
        self.capacity = cfg.pa_classes[cls_idx]
        self.count = 0
        self.keys = np.zeros(self.capacity, dtype=np.uint64)
        self.ptrs = np.zeros(self.capacity, dtype=np.int64)
        self.block = dev.alloc()

    def insert(self, dev: BlockDevice, key: int, ptr: int) -> None:
        # side="left": an equal key is a duplicate-split's NEW leaf, which
        # precedes the existing one in the sibling chain (paper §4.3.2)
        i = int(np.searchsorted(self.keys[: self.count], np.uint64(key), side="left"))
        self.keys[i + 1 : self.count + 1] = self.keys[i : self.count]
        self.ptrs[i + 1 : self.count + 1] = self.ptrs[i : self.count]
        self.keys[i] = key
        self.ptrs[i] = ptr
        self.count += 1
        dev.write(self.block)

    def entries(self) -> list[tuple[int, int]]:
        return [(int(self.keys[i]), int(self.ptrs[i])) for i in range(self.count)]


class BTreeNode:
    """Two-layer B+-tree: a root block with <= 4 child blocks of <= 255 pairs."""

    __slots__ = ("root_block", "child_blocks", "child_keys", "child_ptrs",
                 "child_count", "_cap", "_maxc")

    def __init__(self, cfg: AulidConfig, dev: BlockDevice):
        self._cap = cfg.bt_child_capacity
        self._maxc = cfg.bt_max_children
        self.root_block = dev.alloc()
        self.child_blocks: list[int] = []
        self.child_keys: list[np.ndarray] = []
        self.child_ptrs: list[np.ndarray] = []
        self.child_count: list[int] = []

    @property
    def count(self) -> int:
        return sum(self.child_count)

    def is_full(self) -> bool:
        return (len(self.child_blocks) == self._maxc
                and all(c >= self._cap for c in self.child_count))

    def would_overflow(self, key: int) -> bool:
        """True when inserting ``key`` requires converting to a mixed node
        (Algorithm 1 lines 15-17): the target child is at capacity and no
        split is possible. The all-duplicate child is the one corner case
        where in-place growth is allowed instead (ranks cannot split)."""
        if not self.child_blocks:
            return False
        j = self.child_for(key)
        c = self.child_count[j]
        if c < len(self.child_keys[j]):
            return False
        if len(self.child_blocks) < self._maxc:
            return False
        ks = self.child_keys[j][:c]
        return int(ks[0]) != int(ks[-1])

    def pivots(self) -> list[int]:
        """Max key per child (routing keys stored in the root block)."""
        return [int(self.child_keys[j][self.child_count[j] - 1])
                for j in range(len(self.child_blocks))]

    def _new_child(self, dev: BlockDevice, at: int, cap: Optional[int] = None) -> None:
        cap = max(self._cap, cap or 0)
        self.child_blocks.insert(at, dev.alloc())
        self.child_keys.insert(at, np.zeros(cap, dtype=np.uint64))
        self.child_ptrs.insert(at, np.zeros(cap, dtype=np.int64))
        self.child_count.insert(at, 0)

    def bulk_fill(self, dev: BlockDevice, keys: np.ndarray, ptrs: np.ndarray) -> None:
        n = len(keys)
        nchild = min(self._maxc, max(1, -(-n // self._cap)))
        per = -(-n // nchild)  # may exceed _cap only in the degenerate
        off = 0                # all-duplicate-keys corner case (see DESIGN.md)
        for _ in range(nchild):
            take = min(per, n - off)
            self._new_child(dev, len(self.child_blocks), cap=take)
            j = len(self.child_blocks) - 1
            self.child_keys[j][:take] = keys[off : off + take]
            self.child_ptrs[j][:take] = ptrs[off : off + take]
            self.child_count[j] = take
            dev.write(self.child_blocks[j])
            off += take
        dev.write(self.root_block)

    def child_for(self, key: int) -> int:
        piv = self.pivots()
        for j, p in enumerate(piv):
            if key <= p:
                return j
        return len(piv) - 1

    def insert(self, dev: BlockDevice, key: int, ptr: int) -> None:
        dev.read(self.root_block)
        j = self.child_for(key)
        # If the target child is full but the node is not, split the child.
        if (self.child_count[j] >= len(self.child_keys[j])
                and len(self.child_blocks) < self._maxc):
            c = self.child_count[j]
            half = c // 2
            self._new_child(dev, j + 1, cap=c - half)
            self.child_keys[j + 1][: c - half] = self.child_keys[j][half:c]
            self.child_ptrs[j + 1][: c - half] = self.child_ptrs[j][half:c]
            self.child_count[j + 1] = c - half
            self.child_count[j] = half
            dev.write(self.child_blocks[j])
            dev.write(self.child_blocks[j + 1])
            dev.write(self.root_block)
            if key > int(self.child_keys[j][half - 1]):
                j += 1
        c = self.child_count[j]
        if c >= len(self.child_keys[j]):  # degenerate duplicate-heavy overflow
            grow = np.zeros(c * 2, dtype=np.uint64)
            grow[:c] = self.child_keys[j][:c]
            self.child_keys[j] = grow
            growp = np.zeros(c * 2, dtype=np.int64)
            growp[:c] = self.child_ptrs[j][:c]
            self.child_ptrs[j] = growp
        i = int(np.searchsorted(self.child_keys[j][:c], np.uint64(key), side="left"))
        self.child_keys[j][i + 1 : c + 1] = self.child_keys[j][i:c]
        self.child_ptrs[j][i + 1 : c + 1] = self.child_ptrs[j][i:c]
        self.child_keys[j][i] = key
        self.child_ptrs[j][i] = ptr
        self.child_count[j] = c + 1
        dev.write(self.child_blocks[j])

    def entries(self) -> list[tuple[int, int]]:
        out = []
        for j in range(len(self.child_blocks)):
            for i in range(self.child_count[j]):
                out.append((int(self.child_keys[j][i]), int(self.child_ptrs[j][i])))
        return out

    def free(self, dev: BlockDevice) -> None:
        dev.free(self.root_block)
        for b in self.child_blocks:
            dev.free(b)


class MixedNode:
    """FMCD-modelled inner node. The model is *stored in the parent* (paper
    §3.3.2) so traversing into this node costs exactly one block read — the
    block containing the predicted slot."""

    __slots__ = ("fanout", "model", "blocks", "tags", "keys", "ptrs", "objs",
                 "size", "init_size", "direct_data", "fulfilled")

    def __init__(self, cfg: AulidConfig, dev: BlockDevice, fanout: int,
                 model: LinearModel):
        self.fanout = fanout
        self.model = model
        nblocks = -(-fanout // cfg.mixed_slots_per_block)
        self.blocks = [dev.alloc() for _ in range(nblocks)]
        self.tags = np.zeros(fanout, dtype=np.uint8)
        self.keys = np.zeros(fanout, dtype=np.uint64)
        self.ptrs = np.full(fanout, -1, dtype=np.int64)
        self.objs: dict[int, object] = {}   # slot -> PackedArray | BTreeNode | MixedNode
        self.size = 0          # inner entries in the subtree rooted here
        self.init_size = 0
        self.direct_data = 0   # entries stored as TAG_DATA directly in this node
        self.fulfilled = np.zeros(fanout, dtype=bool)  # Fulfill backfill marks

    def slot_block(self, cfg: AulidConfig, slot: int) -> int:
        return self.blocks[slot // cfg.mixed_slots_per_block]

    def predict(self, key: int) -> int:
        p = int(self.model.slope * float(key) + self.model.intercept)
        return min(max(p, 0), self.fanout - 1)

    def next_occupied(self, slot: int) -> int:
        """Index of the first non-NULL slot at or after ``slot`` (or fanout)."""
        sub = self.tags[slot:]
        nz = np.nonzero(sub != TAG_NULL)[0]
        return slot + int(nz[0]) if nz.size else self.fanout

    def mixed_children(self):
        return [o for o in self.objs.values() if isinstance(o, MixedNode)]

    def l3_items(self) -> int:
        """Entries at relative layer >= 3 (Adjust criterion 1, exact)."""
        return sum(c.size - c.direct_data for c in self.mixed_children())

    def free(self, dev: BlockDevice, recursive: bool = True) -> None:
        for b in self.blocks:
            dev.free(b)
        if recursive:
            for obj in self.objs.values():
                if isinstance(obj, PackedArray):
                    dev.free(obj.block)
                elif isinstance(obj, BTreeNode):
                    obj.free(dev)
                elif isinstance(obj, MixedNode):
                    obj.free(dev, recursive=True)


class Aulid(OrderedIndex):
    name = "aulid"

    def __init__(self, dev: Optional[BlockDevice] = None,
                 cfg: Optional[AulidConfig] = None, **kw: object):
        super().__init__(dev)
        self.cfg = cfg if cfg is not None else (AulidConfig(**kw) if kw else AulidConfig())
        self.root: Optional[MixedNode] = None
        # Metanode (main-memory, 80 bytes in the paper §3.3.1):
        self.last_leaf: int = -1
        self.last_leaf_min: int = 0
        self.last_leaf_max: int = 0
        self.first_leaf: int = -1
        # Host-side leaf store: block id -> content arrays. The canonical bytes
        # also live in the BlockDevice (serialized on write) — see blockdev.py.
        self.leaf_keys: dict[int, np.ndarray] = {}
        self.leaf_pay: dict[int, np.ndarray] = {}
        self.leaf_count: dict[int, int] = {}
        self.leaf_next: dict[int, int] = {}
        self.leaf_prev: dict[int, int] = {}
        self.n_items = 0
        # SMO counters (paper §5.2.3 / Figs 13-15)
        self.smo_leaf_splits = 0
        self.smo_node_creates = 0
        self.smo_adjusts = 0
        # Host walk counters (always on, like smo_*): root-to-leaf walks
        # (``_find_leaf`` calls), NULL forward scans in ``_resolve_slot``,
        # and the tag slots those scans examine (``fanout - slot`` each:
        # ``MixedNode.next_occupied`` runs over the node's whole tail)
        self.leaf_walks = 0
        self.null_scans = 0
        self.null_scan_slots = 0
        # Change journal since bulkload (DESIGN.md §3): consumed by the
        # incremental mirror refresh and the serving engine's delta overlay.
        # ``journal_base`` is the absolute position of journal[0]: refresh
        # truncates consumed prefixes (bounding memory under sustained
        # writes) while mirror epochs — absolute positions — stay monotonic.
        self.journal: list[JournalEntry] = []
        self.journal_base = 0

    @property
    def journal_end(self) -> int:
        """Absolute journal position of the next entry to be appended."""
        return self.journal_base + len(self.journal)

    def smo_state(self) -> tuple[int, int, int, int]:
        """SMO fingerprint: unchanged iff the inner structure and the leaf
        set are unchanged (leaf unlinks shrink the leaf-dict length)."""
        return (self.smo_leaf_splits, self.smo_node_creates,
                self.smo_adjusts, len(self.leaf_count))

    # ------------------------------------------------------------------ leaves
    def _new_leaf(self) -> int:
        bid = self.dev.alloc()
        cap = self.cfg.leaf_capacity
        self.leaf_keys[bid] = np.zeros(cap, dtype=np.uint64)
        self.leaf_pay[bid] = np.zeros(cap, dtype=np.uint64)
        self.leaf_count[bid] = 0
        self.leaf_next[bid] = -1
        self.leaf_prev[bid] = -1
        return bid

    def _write_leaf(self, bid: int) -> None:
        # Serialize keys+payloads into the device block (512 u64 words = 4 KB).
        cap = min(self.cfg.leaf_capacity, self.dev.words_per_block // 2)
        words = self.dev.write(bid)
        words[:cap] = self.leaf_keys[bid][:cap]
        words[cap : 2 * cap] = self.leaf_pay[bid][:cap]

    def _leaf_max(self, bid: int) -> int:
        return int(self.leaf_keys[bid][self.leaf_count[bid] - 1])

    def _leaf_min(self, bid: int) -> int:
        return int(self.leaf_keys[bid][0])

    # ---------------------------------------------------------------- bulkload
    def bulkload(self, keys: np.ndarray, payloads: np.ndarray) -> None:
        """Paper §4.1: build leaves, then FMCD inner nodes over (max key, block)."""
        keys = np.asarray(keys, dtype=np.uint64)
        payloads = np.asarray(payloads, dtype=np.uint64)
        assert keys.ndim == 1 and keys.shape == payloads.shape
        assert np.all(keys[1:] >= keys[:-1]), "bulkload requires sorted keys"
        n = len(keys)
        self.n_items = n
        self.journal_base += len(self.journal)
        self.journal.clear()
        fill = max(1, int(self.cfg.leaf_capacity * self.cfg.leaf_fill))
        nleaves = max(1, -(-n // fill))
        entry_keys = np.zeros(max(nleaves - 1, 0), dtype=np.uint64)
        entry_ptrs = np.zeros(max(nleaves - 1, 0), dtype=np.int64)
        prev = -1
        for li in range(nleaves):
            bid = self._new_leaf()
            lo, hi = li * fill, min((li + 1) * fill, n)
            take = hi - lo
            self.leaf_keys[bid][:take] = keys[lo:hi]
            self.leaf_pay[bid][:take] = payloads[lo:hi]
            self.leaf_count[bid] = take
            self.leaf_prev[bid] = prev
            if prev >= 0:
                self.leaf_next[prev] = bid
            else:
                self.first_leaf = bid
            self._write_leaf(bid)
            if li < nleaves - 1:
                entry_keys[li] = keys[hi - 1]
                entry_ptrs[li] = bid
            else:
                self.last_leaf = bid
                self.last_leaf_min = int(keys[lo]) if take else 0
                self.last_leaf_max = int(keys[n - 1]) if take else 0
            prev = bid
        if len(entry_keys):
            self.root = self._build_mixed(entry_keys, entry_ptrs)
        else:
            self.root = None

    def _build_mixed(self, keys: np.ndarray, ptrs: np.ndarray) -> MixedNode:
        """BuildMixedNode (paper §4.1): FMCD model + 3-way conflict split."""
        cfg = self.cfg
        n = len(keys)
        fanout = min(max(cfg.fanout_mult * n, cfg.min_fanout), cfg.max_fanout)
        model, _ = fmcd(keys, fanout)
        node = MixedNode(cfg, self.dev, fanout, model)
        self.smo_node_creates += 1
        slots = model.predict_clipped(keys, fanout)
        uniq, starts = np.unique(slots, return_index=True)
        bounds = list(starts) + [n]
        for gi, slot in enumerate(uniq):
            lo, hi = bounds[gi], bounds[gi + 1]
            c = hi - lo
            slot = int(slot)
            if c == 1:
                node.tags[slot] = TAG_DATA
                node.keys[slot] = keys[lo]
                node.ptrs[slot] = ptrs[lo]
                node.direct_data += 1
            elif cfg.lipp_inner and len(np.unique(keys[lo:hi])) > 1 and c < n:
                child = self._build_mixed(keys[lo:hi], ptrs[lo:hi])
                node.tags[slot] = TAG_MIXED
                node.keys[slot] = keys[hi - 1]
                node.objs[slot] = child
            elif c < cfg.pa_threshold:
                pa = self._make_pa_for(c)
                pa.keys[:c] = keys[lo:hi]
                pa.ptrs[:c] = ptrs[lo:hi]
                pa.count = c
                self.dev.write(pa.block)
                node.tags[slot] = TAG_PA
                node.keys[slot] = keys[hi - 1]
                node.objs[slot] = pa
            elif c < cfg.bt_threshold or len(np.unique(keys[lo:hi])) == 1 or c == n:
                bt = BTreeNode(cfg, self.dev)
                self.smo_node_creates += 1
                bt.bulk_fill(self.dev, keys[lo:hi], ptrs[lo:hi])
                node.tags[slot] = TAG_BT
                node.keys[slot] = keys[hi - 1]
                node.objs[slot] = bt
            else:
                child = self._build_mixed(keys[lo:hi], ptrs[lo:hi])
                node.tags[slot] = TAG_MIXED
                node.keys[slot] = keys[hi - 1]
                node.objs[slot] = child
        node.size = n
        node.init_size = n
        for b in node.blocks:
            self.dev.write(b)
        if cfg.fulfill:
            self._fulfill(node)
        return node

    def _make_pa_for(self, c: int) -> PackedArray:
        cfg = self.cfg
        for i, cap in enumerate(cfg.pa_classes):
            if c <= cap:
                self.smo_node_creates += 1
                return PackedArray(cfg, self.dev, i)
        raise AssertionError(f"packed array request too large: {c}")

    def _fulfill(self, node: MixedNode) -> None:
        """Fulfill read optimization (paper §4.2.3): backfill NULL runs that
        precede a DATA slot with a copy of that DATA entry (read-only)."""
        tags, keys, ptrs = node.tags, node.keys, node.ptrs
        nxt_key, nxt_ptr, have = 0, -1, False
        for s in range(node.fanout - 1, -1, -1):
            if tags[s] == TAG_DATA and not node.fulfilled[s]:
                nxt_key, nxt_ptr, have = int(keys[s]), int(ptrs[s]), True
            elif tags[s] == TAG_NULL and have:
                tags[s] = TAG_DATA
                keys[s] = nxt_key
                ptrs[s] = nxt_ptr
                node.fulfilled[s] = True
            elif tags[s] != TAG_NULL:
                have = False

    def _defulfill(self, node: MixedNode) -> None:
        """First write to a fulfilled node reverts the backfill (paper: Fulfill
        'only works with Read-Only workloads')."""
        if node.fulfilled.any():
            touched = np.unique(np.nonzero(node.fulfilled)[0]
                                // self.cfg.mixed_slots_per_block)
            node.tags[node.fulfilled] = TAG_NULL
            node.ptrs[node.fulfilled] = -1
            node.fulfilled[:] = False
            for b in touched:
                self.dev.write(node.blocks[int(b)])

    # ------------------------------------------------------------------ lookup
    def _resolve_slot(self, node: MixedNode, slot: int, key: int) -> int:
        """Resolve a slot to a leaf block id for ``key``.

        Implements the five slot cases of §4.2.1 with the ScanFward
        optimization of §4.2.3. Returns a leaf block id (last leaf acts as the
        global successor sentinel). Assumes the block containing ``slot`` was
        already read by the caller.

        A stack of (ancestor, resume_slot) frames handles the case where the
        search exhausts a child mixed node (all of its entries < key): the
        forward scan then continues at the ancestor's next slot — the on-disk
        equivalent of the device mirror's ``overflow_minleaf``."""
        cfg, dev = self.cfg, self.dev
        stack: list[tuple[MixedNode, int]] = []
        while True:
            if slot >= node.fanout:
                if not stack:
                    return self.last_leaf
                node, slot = stack.pop()
                # resuming in the ancestor block: one read unless it is the
                # same block the descent came from (slot-1's block)
                if slot < node.fanout and (slot // cfg.mixed_slots_per_block
                                           != (slot - 1) // cfg.mixed_slots_per_block):
                    dev.read(node.slot_block(cfg, slot))
                continue
            tag = int(node.tags[slot])
            if tag == TAG_NULL:
                # Issue 2 (§4.2.3): scan forward to the next DATA-ish slot;
                # each block boundary crossed costs one extra read.
                self.null_scans += 1
                self.null_scan_slots += node.fanout - slot
                nxt = node.next_occupied(slot)
                spb = cfg.mixed_slots_per_block
                last = min(nxt, node.fanout - 1)
                extra = last // spb - slot // spb
                for i in range(extra):
                    dev.read(node.blocks[slot // spb + 1 + i])
                slot = nxt  # past-end resumes in the ancestor (loop head)
                continue
            if tag == TAG_DATA:
                skey = int(node.keys[slot])
                if skey >= key:
                    return int(node.ptrs[slot])
                # Issue 1 (§4.2.3): entry's max key < search key -> successor.
                if cfg.scanfward:
                    spb = cfg.mixed_slots_per_block
                    blk_end = min((slot // spb + 1) * spb, node.fanout)
                    sub = node.tags[slot + 1 : blk_end]
                    nz = np.nonzero(sub != TAG_NULL)[0]
                    if nz.size:  # another entry in the already-fetched block
                        slot = slot + 1 + int(nz[0])
                        continue
                # Fall back: fetch this leaf, then follow its sibling link
                # (one extra block read — paper §4.2.3 Issue 1).
                leaf = int(node.ptrs[slot])
                dev.read(leaf)
                nxt_leaf = self.leaf_next.get(leaf, -1)
                return nxt_leaf if nxt_leaf >= 0 else self.last_leaf
            if tag == TAG_PA:
                pa: PackedArray = node.objs[slot]  # type: ignore[assignment]
                dev.read(pa.block)
                i = int(np.searchsorted(pa.keys[: pa.count], np.uint64(key), side="left"))
                if i < pa.count:
                    return int(pa.ptrs[i])
                slot += 1  # all entries < key: successor is in a later slot
                continue
            if tag == TAG_BT:
                bt: BTreeNode = node.objs[slot]  # type: ignore[assignment]
                dev.read(bt.root_block)
                j = bt.child_for(key)
                dev.read(bt.child_blocks[j])
                c = bt.child_count[j]
                i = int(np.searchsorted(bt.child_keys[j][:c], np.uint64(key), side="left"))
                if i < c:
                    return int(bt.child_ptrs[j][i])
                slot += 1
                continue
            # TAG_MIXED: descend (child model came for free with this block).
            child: MixedNode = node.objs[slot]  # type: ignore[assignment]
            stack.append((node, slot + 1))
            node = child
            slot = child.predict(key)
            dev.read(child.slot_block(cfg, slot))

    def _find_leaf(self, key: int) -> int:
        """Root-to-leaf traversal returning the candidate leaf block id."""
        self.leaf_walks += 1
        # Metanode check (in-memory, no I/O): last-leaf shortcut (§4.2.1).
        if self.last_leaf >= 0 and key >= self.last_leaf_min:
            return self.last_leaf
        if self.root is None:
            return self.last_leaf
        slot = self.root.predict(key)
        self.dev.read(self.root.slot_block(self.cfg, slot))
        return self._resolve_slot(self.root, slot, key)

    def lookup(self, key: int) -> Optional[int]:
        key = int(key)
        leaf = self._find_leaf(key)
        if leaf < 0:
            return None
        self.dev.read(leaf)
        c = self.leaf_count[leaf]
        i = int(np.searchsorted(self.leaf_keys[leaf][:c], np.uint64(key), side="left"))
        if i < c and int(self.leaf_keys[leaf][i]) == key:
            return int(self.leaf_pay[leaf][i])
        return None

    def scan(self, start_key: int, count: int) -> list[tuple[int, int]]:
        """§4.2.2: lookup the start position, then walk sibling links."""
        start_key = int(start_key)
        leaf = self._find_leaf(start_key)
        out: list[tuple[int, int]] = []
        if leaf < 0:
            return out
        self.dev.read(leaf)
        # duplicate runs may span leaves: walk back to the FIRST leaf whose
        # max >= start_key (paper §4.3.2 — sibling links make this cheap;
        # each hop is one accounted block read)
        while True:
            prev = self.leaf_prev.get(leaf, -1)
            if prev < 0 or self.leaf_count.get(prev, 0) == 0 \
                    or self._leaf_max(prev) < start_key:
                break
            leaf = prev
            self.dev.read(leaf)
        c = self.leaf_count[leaf]
        i = int(np.searchsorted(self.leaf_keys[leaf][:c], np.uint64(start_key), side="left"))
        while len(out) < count and leaf >= 0:
            c = self.leaf_count[leaf]
            take = min(count - len(out), c - i)
            if take > 0:
                ks = self.leaf_keys[leaf][i : i + take]
                ps = self.leaf_pay[leaf][i : i + take]
                out.extend(zip(ks.tolist(), ps.tolist()))
            leaf = self.leaf_next.get(leaf, -1)
            i = 0
            if len(out) < count and leaf >= 0:
                self.dev.read(leaf)
        return out

    # ------------------------------------------------------------------ insert
    def insert(self, key: int, payload: int) -> None:
        """Paper §4.3.1 / Algorithm 1."""
        key = int(key)
        cfg, dev = self.cfg, self.dev
        dev.set_tag("search")
        leaf = self._find_leaf(key)
        if leaf < 0:  # empty index
            dev.set_tag("leaf")
            bid = self._new_leaf()
            self.leaf_keys[bid][0] = key
            self.leaf_pay[bid][0] = payload
            self.leaf_count[bid] = 1
            self._write_leaf(bid)
            self.first_leaf = self.last_leaf = bid
            self.last_leaf_min = self.last_leaf_max = key
            self.n_items = 1
            self.journal.append(JournalEntry("insert", key, int(payload), bid))
            dev.set_tag(None)
            return
        dev.read(leaf)
        dev.set_tag("leaf")
        if self.leaf_count[leaf] < cfg.leaf_capacity:
            self._leaf_insert(leaf, key, payload)
            dev.set_tag(None)
            return
        # Split: AULID keeps the *larger* half in the original block so the
        # existing inner entry (max key -> original block) stays valid (§4.3.1).
        new_leaf = self._new_leaf()
        c = self.leaf_count[leaf]
        half = c // 2
        self.leaf_keys[new_leaf][:half] = self.leaf_keys[leaf][:half]
        self.leaf_pay[new_leaf][:half] = self.leaf_pay[leaf][:half]
        self.leaf_count[new_leaf] = half
        self.leaf_keys[leaf][: c - half] = self.leaf_keys[leaf][half:c]
        self.leaf_pay[leaf][: c - half] = self.leaf_pay[leaf][half:c]
        self.leaf_count[leaf] = c - half
        # sibling links: new (smaller-half) leaf goes *before* the original
        prev = self.leaf_prev.get(leaf, -1)
        self.leaf_prev[new_leaf] = prev
        self.leaf_next[new_leaf] = leaf
        self.leaf_prev[leaf] = new_leaf
        if prev >= 0:
            self.leaf_next[prev] = new_leaf
        else:
            self.first_leaf = new_leaf
        self._write_leaf(new_leaf)
        self._write_leaf(leaf)
        self.smo_leaf_splits += 1
        if leaf == self.last_leaf:
            self.last_leaf_min = self._leaf_min(leaf)
        # Insert the target pair into whichever half owns it.
        target = new_leaf if key <= self._leaf_max(new_leaf) or (
            self._leaf_min(leaf) > key) else leaf
        self._leaf_insert(target, key, payload)
        # Index the new (smaller-half) leaf in the inner part.
        dev.set_tag("inner")
        k_max = self._leaf_max(new_leaf)
        accessed: list[MixedNode] = []
        self._inner_insert(k_max, new_leaf, accessed)
        dev.set_tag("adjust")
        self._adjust(accessed)
        dev.set_tag(None)

    def _leaf_insert(self, leaf: int, key: int, payload: int) -> None:
        c = self.leaf_count[leaf]
        i = int(np.searchsorted(self.leaf_keys[leaf][:c], np.uint64(key), side="right"))
        self.leaf_keys[leaf][i + 1 : c + 1] = self.leaf_keys[leaf][i:c]
        self.leaf_pay[leaf][i + 1 : c + 1] = self.leaf_pay[leaf][i:c]
        self.leaf_keys[leaf][i] = key
        self.leaf_pay[leaf][i] = payload
        self.leaf_count[leaf] = c + 1
        self._write_leaf(leaf)
        self.n_items += 1
        self.journal.append(JournalEntry("insert", key, int(payload), leaf))
        if leaf == self.last_leaf:
            self.last_leaf_min = self._leaf_min(leaf)
            self.last_leaf_max = self._leaf_max(leaf)

    def _inner_insert(self, key: int, ptr: int, accessed: list[MixedNode]) -> None:
        """FindEntry + the four insert cases of Algorithm 1 (lines 5-26)."""
        cfg, dev = self.cfg, self.dev
        if self.root is None:
            self.root = self._build_mixed(
                np.array([key], dtype=np.uint64), np.array([ptr], dtype=np.int64))
            return
        node = self.root
        while True:
            self._defulfill(node)
            accessed.append(node)
            node.size += 1
            slot = node.predict(key)
            dev.read(node.slot_block(cfg, slot))
            tag = int(node.tags[slot])
            if tag == TAG_MIXED:
                node = node.objs[slot]  # type: ignore[assignment]
                continue
            break
        if tag == TAG_NULL:
            node.tags[slot] = TAG_DATA
            node.keys[slot] = key
            node.ptrs[slot] = ptr
            node.direct_data += 1
            dev.write(node.slot_block(cfg, slot))
            return
        if tag == TAG_DATA and cfg.lipp_inner \
                and int(node.keys[slot]) != key:
            # LIPP-B+: a conflict immediately becomes a child mixed node
            ek, ep = int(node.keys[slot]), int(node.ptrs[slot])
            pair = sorted([(ek, ep), (key, ptr)])
            child = self._build_mixed(
                np.array([p[0] for p in pair], dtype=np.uint64),
                np.array([p[1] for p in pair], dtype=np.int64))
            node.tags[slot] = TAG_MIXED
            node.keys[slot] = pair[1][0]
            node.objs[slot] = child
            node.direct_data -= 1
            dev.write(node.slot_block(cfg, slot))
            return
        if tag == TAG_DATA:
            pa = self._make_pa_for(2)
            ek, ep = int(node.keys[slot]), int(node.ptrs[slot])
            # equal keys: the NEW entry (a duplicate-split's smaller-half
            # leaf) precedes the existing one in the sibling chain
            a, b = (((key, ptr), (ek, ep)) if key <= ek
                    else ((ek, ep), (key, ptr)))
            pa.keys[0], pa.ptrs[0] = a
            pa.keys[1], pa.ptrs[1] = b
            pa.count = 2
            dev.write(pa.block)
            node.tags[slot] = TAG_PA
            node.keys[slot] = max(ek, key)
            node.ptrs[slot] = -1
            node.objs[slot] = pa
            node.direct_data -= 1
            dev.write(node.slot_block(cfg, slot))
            return
        if tag == TAG_PA:
            pa = node.objs[slot]
            assert isinstance(pa, PackedArray)
            dev.read(pa.block)
            if pa.count < pa.capacity:
                pa.insert(dev, key, ptr)
                if key > int(node.keys[slot]):
                    node.keys[slot] = key
                    dev.write(node.slot_block(cfg, slot))
                return
            # Full: grow to the next packed-array class, or convert to a
            # two-layer B+-tree at the largest class (Algorithm 1 lines 20-24).
            entries = pa.entries() + [(key, ptr)]
            entries.sort()
            ks = np.array([e[0] for e in entries], dtype=np.uint64)
            ps = np.array([e[1] for e in entries], dtype=np.int64)
            if pa.cls_idx + 1 < len(cfg.pa_classes):
                npa = PackedArray(cfg, dev, pa.cls_idx + 1)
                self.smo_node_creates += 1
                npa.keys[: len(ks)] = ks
                npa.ptrs[: len(ps)] = ps
                npa.count = len(ks)
                dev.write(npa.block)
                node.objs[slot] = npa
            else:
                bt = BTreeNode(cfg, dev)
                self.smo_node_creates += 1
                bt.bulk_fill(dev, ks, ps)
                node.tags[slot] = TAG_BT
                node.objs[slot] = bt
            dev.free(pa.block)
            node.keys[slot] = int(ks[-1])
            dev.write(node.slot_block(cfg, slot))
            return
        # TAG_BT
        bt = node.objs[slot]
        assert isinstance(bt, BTreeNode)
        if not bt.would_overflow(key):
            bt.insert(dev, key, ptr)
            if key > int(node.keys[slot]):
                node.keys[slot] = key
                dev.write(node.slot_block(cfg, slot))
            return
        # Full: convert into a new mixed node (Algorithm 1 lines 15-17).
        entries = bt.entries() + [(key, ptr)]
        entries.sort()
        ks = np.array([e[0] for e in entries], dtype=np.uint64)
        ps = np.array([e[1] for e in entries], dtype=np.int64)
        child = self._build_mixed(ks, ps)
        bt.free(dev)
        node.tags[slot] = TAG_MIXED
        node.keys[slot] = int(ks[-1])
        node.objs[slot] = child
        dev.write(node.slot_block(cfg, slot))

    # ------------------------------------------------------------------ adjust
    def _adjust(self, accessed: list[MixedNode]) -> None:
        """Algorithm 2: rebuild a mixed node when both criteria hold.

        l3 is computed exactly from per-node aggregates (class docstring)."""
        cfg = self.cfg
        for i in range(len(accessed) - 1, -1, -1):
            n = accessed[i]
            if n.size >= cfg.beta * n.init_size and n.l3_items() >= cfg.alpha * n.size:
                entries = self._collect(n, count_io=True)
                ks = np.array([e[0] for e in entries], dtype=np.uint64)
                ps = np.array([e[1] for e in entries], dtype=np.int64)
                parent = accessed[i - 1] if i > 0 else None
                rebuilt = self._build_mixed(ks, ps)
                self.smo_adjusts += 1
                n.free(self.dev)
                if parent is None:
                    self.root = rebuilt
                else:
                    for slot, obj in parent.objs.items():
                        if obj is n:
                            parent.objs[slot] = rebuilt
                            self.dev.write(parent.slot_block(cfg, slot))
                            break
                break  # deeper nodes were subsumed by the rebuild

    def _collect(self, node: MixedNode, count_io: bool = False) -> list[tuple[int, int]]:
        """All (max key, leaf block) entries in the inner subtree of ``node``."""
        dev = self.dev
        if count_io:
            for b in node.blocks:
                dev.read(b)
        out: list[tuple[int, int]] = []
        for slot in np.nonzero(node.tags != TAG_NULL)[0]:
            slot = int(slot)
            if node.fulfilled[slot]:
                continue
            tag = int(node.tags[slot])
            obj = node.objs.get(slot)
            if tag == TAG_DATA:
                out.append((int(node.keys[slot]), int(node.ptrs[slot])))
            elif tag == TAG_PA:
                if count_io:
                    dev.read(obj.block)            # type: ignore[union-attr]
                out.extend(obj.entries())          # type: ignore[union-attr]
            elif tag == TAG_BT:
                if count_io:
                    dev.read(obj.root_block)       # type: ignore[union-attr]
                    for b in obj.child_blocks:     # type: ignore[union-attr]
                        dev.read(b)
                out.extend(obj.entries())          # type: ignore[union-attr]
            else:
                out.extend(self._collect(obj, count_io))  # type: ignore[arg-type]
        return out

    # ---------------------------------------------------------------- delete &c
    def delete(self, key: int) -> bool:
        """Paper §4.5: delete at the leaf; inner entries are only touched when
        the leaf empties (merge-with-sibling semantics simplified to removal)."""
        key = int(key)
        leaf = self._find_leaf(key)
        if leaf < 0:
            return False
        self.dev.read(leaf)
        c = self.leaf_count[leaf]
        i = int(np.searchsorted(self.leaf_keys[leaf][:c], np.uint64(key), side="left"))
        if i >= c or int(self.leaf_keys[leaf][i]) != key:
            return False
        self.leaf_keys[leaf][i : c - 1] = self.leaf_keys[leaf][i + 1 : c]
        self.leaf_pay[leaf][i : c - 1] = self.leaf_pay[leaf][i + 1 : c]
        self.leaf_count[leaf] = c - 1
        self._write_leaf(leaf)
        self.n_items -= 1
        self.journal.append(JournalEntry("delete", key, 0, leaf))
        if leaf == self.last_leaf and self.leaf_count[leaf] > 0:
            self.last_leaf_min = self._leaf_min(leaf)
            self.last_leaf_max = self._leaf_max(leaf)
        # Paper: no inner update unless an SMO (empty leaf) is required.
        if self.leaf_count[leaf] == 0 and leaf != self.last_leaf:
            self._unlink_leaf(leaf)
            self._inner_delete(leaf)
        return True

    def _unlink_leaf(self, leaf: int) -> None:
        prev, nxt = self.leaf_prev.get(leaf, -1), self.leaf_next.get(leaf, -1)
        if prev >= 0:
            self.leaf_next[prev] = nxt
            self.dev.write(prev)
        if nxt >= 0:
            self.leaf_prev[nxt] = prev
            self.dev.write(nxt)
        if self.first_leaf == leaf:
            self.first_leaf = nxt
        self.dev.free(leaf)
        for d in (self.leaf_keys, self.leaf_pay, self.leaf_count,
                  self.leaf_next, self.leaf_prev):
            d.pop(leaf, None)

    def _inner_delete(self, leaf: int) -> None:
        """Remove the inner entry pointing at ``leaf`` (paper §4.5): NULL the
        mixed slot, or remove from the PA/BT and collapse it to DATA at one."""
        cfg, dev = self.cfg, self.dev

        def walk(node: MixedNode) -> bool:
            self._defulfill(node)
            hits = np.nonzero((node.ptrs == leaf) & (node.tags == TAG_DATA))[0]
            if hits.size:
                s = int(hits[0])
                dev.read(node.slot_block(cfg, s))
                node.tags[s] = TAG_NULL
                node.ptrs[s] = -1
                node.direct_data -= 1
                node.size -= 1
                dev.write(node.slot_block(cfg, s))
                return True
            for s, obj in list(node.objs.items()):
                if isinstance(obj, MixedNode):
                    continue
                entries = obj.entries()
                kept = [e for e in entries if e[1] != leaf]
                if len(kept) == len(entries):
                    continue
                dev.read(node.slot_block(cfg, s))
                node.size -= 1
                if len(kept) == 1:  # collapse to DATA (paper §4.5)
                    if isinstance(obj, PackedArray):
                        dev.free(obj.block)
                    else:
                        obj.free(dev)
                    node.tags[s] = TAG_DATA
                    node.keys[s] = kept[0][0]
                    node.ptrs[s] = kept[0][1]
                    node.direct_data += 1
                    node.objs.pop(s)
                else:
                    ks = np.array([e[0] for e in kept], dtype=np.uint64)
                    ps = np.array([e[1] for e in kept], dtype=np.int64)
                    if isinstance(obj, PackedArray):
                        obj.keys[: len(ks)] = ks
                        obj.ptrs[: len(ps)] = ps
                        obj.count = len(ks)
                        dev.write(obj.block)
                    else:
                        obj.free(dev)
                        bt = BTreeNode(cfg, dev)
                        bt.bulk_fill(dev, ks, ps)
                        node.objs[s] = bt
                    node.keys[s] = int(ks[-1])
                dev.write(node.slot_block(cfg, s))
                return True
            for obj in node.mixed_children():
                if walk(obj):
                    node.size -= 1
                    return True
            return False

        if self.root is not None:
            walk(self.root)

    def update(self, key: int, payload: int) -> bool:
        """In-place payload update (paper §4.5)."""
        key = int(key)
        leaf = self._find_leaf(key)
        if leaf < 0:
            return False
        self.dev.read(leaf)
        c = self.leaf_count[leaf]
        i = int(np.searchsorted(self.leaf_keys[leaf][:c], np.uint64(key), side="left"))
        if i < c and int(self.leaf_keys[leaf][i]) == key:
            self.leaf_pay[leaf][i] = payload
            self._write_leaf(leaf)
            self.journal.append(JournalEntry("update", key, int(payload), leaf))
            return True
        return False

    # ------------------------------------------------------------ introspection
    def inner_height(self) -> int:
        def h(n: Optional[MixedNode]) -> int:
            if n is None:
                return 0
            sub = [h(o) for o in n.mixed_children()]
            return 1 + (max(sub) if sub else 0)
        return h(self.root)

    def avg_data_slot_height(self) -> float:
        """Average layer of inner entries (paper Table 4)."""
        tot, cnt = 0, 0

        def walk(n: MixedNode, depth: int) -> None:
            nonlocal tot, cnt
            for slot in np.nonzero(n.tags != TAG_NULL)[0]:
                slot = int(slot)
                if n.fulfilled[slot]:
                    continue
                tag = int(n.tags[slot])
                if tag == TAG_DATA:
                    tot, cnt = tot + depth, cnt + 1
                elif tag in (TAG_PA, TAG_BT):
                    c = n.objs[slot].count  # type: ignore[union-attr]
                    tot, cnt = tot + (depth + 1) * c, cnt + c
                else:
                    walk(n.objs[slot], depth + 1)  # type: ignore[arg-type]

        if self.root is not None:
            walk(self.root, 1)
        return tot / cnt if cnt else 0.0

    def check_invariants(self) -> None:
        """Debug/property-test helper: leaf chain sorted & counts consistent."""
        leaf = self.first_leaf
        prev_max = -1
        seen = 0
        while leaf >= 0:
            c = self.leaf_count[leaf]
            ks = self.leaf_keys[leaf][:c]
            assert np.all(ks[1:] >= ks[:-1]), "leaf not sorted"
            if c:
                assert int(ks[0]) >= prev_max, "leaf chain out of order"
                prev_max = int(ks[-1])
            seen += c
            leaf = self.leaf_next.get(leaf, -1)
        assert seen == self.n_items, f"item count mismatch {seen} != {self.n_items}"
