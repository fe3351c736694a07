# Copied from src/repro/core/device_index.py (the port keeps its own copy).
"""Read-only device mirror of an AULID index for batched JAX/Pallas lookups.

The host structure (``aulid.py``) is pointer-based; the TPU adaptation
(DESIGN.md §2) flattens it into dense pools so a *whole batch* of queries
traverses the index with vectorized gathers and **no data-dependent control
flow** — possible because AULID's Adjust mechanism bounds the inner mixed-node
height (<= 3), letting us fully unroll the traversal.

Key precomputations that replace the paper's on-disk forward scans with O(1)
gathers (they are the device-side generalization of the paper's own *Fulfill*
optimization, §4.2.3 — valid because the mirror is a read-only snapshot):

* ``next_occ[s]``   — first non-NULL slot at or after ``s`` within the same
  node; -1 past the node's last entry,
* ``succ_slot[s]``  — for an occupied slot: the next occupied slot in the
  node, or (recursively) the node's successor slot in its ancestor chain;
  -1 at the global end,
* ``node_overflow_slot[n]`` — the ``succ_slot`` of node n viewed as an entry
  of its parent (continuation point when a query runs past n's last entry).

Device traversal is robust to floating-point slot-prediction skew (XLA may
fuse multiply-adds, shifting ``floor(a*k+b)`` by one near slot boundaries):
the prediction — minus a one-slot safety margin — only picks the *starting*
slot; the responsible entry is then found by deterministic integer max-key
comparisons along the ``succ_slot`` chain.  Host placement guarantees stale
entries (max key < q) occur only at slots <= slot(q), so at most 3 chain
steps are ever needed from ``pred-1``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .aulid import (Aulid, BTreeNode, MixedNode, PackedArray,
                    TAG_BT, TAG_DATA, TAG_MIXED, TAG_NULL, TAG_PA)
from .delta_overlay import next_pow2

UINT64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


@dataclasses.dataclass
class DeviceIndex:
    """Flat arrays (numpy here; ``lookup.py`` moves them to jnp)."""
    # slot pools (all mixed nodes concatenated)
    slot_tag: np.ndarray      # (S,) u8
    slot_key: np.ndarray      # (S,) u64   (max key of the slot's entry/subtree)
    slot_ptr: np.ndarray      # (S,) i32   DATA: leaf row, PA/BT: pool row, MIXED: node id
    next_occ: np.ndarray      # (S,) i32   next non-NULL slot in node, -1 past end
    succ_slot: np.ndarray     # (S,) i32   successor entry slot (cross-node), -1 at end
    # node tables
    node_base: np.ndarray     # (N,) i32 first slot index
    node_fanout: np.ndarray   # (N,) i32
    node_slope: np.ndarray    # (N,) f64
    node_intercept: np.ndarray  # (N,) f64
    node_overflow_slot: np.ndarray  # (N,) i32 continuation slot in ancestors (-1 end)
    # packed-array pool (padded to the largest class with +inf keys)
    pa_keys: np.ndarray       # (P, pa_cap) u64
    pa_ptrs: np.ndarray       # (P, pa_cap) i32 leaf rows
    # two-layer B+-tree pool, flattened to one sorted row per BT
    bt_keys: np.ndarray       # (B, bt_cap) u64
    bt_ptrs: np.ndarray       # (B, bt_cap) i32
    # leaf pool
    leaf_keys: np.ndarray     # (L, leaf_cap) u64 (+inf padded)
    leaf_pay: np.ndarray      # (L, leaf_cap) u64
    leaf_count: np.ndarray    # (L,) i32
    leaf_next: np.ndarray     # (L,) i32 row of right sibling, -1 at end
    # metanode
    root_node: int
    last_leaf_row: int
    last_leaf_min: np.uint64
    inner_height: int
    leaf_rows: dict[int, int] = dataclasses.field(default_factory=dict, repr=False)
    # snapshot epoch (DESIGN.md §3): journal position + SMO fingerprint of the
    # host index at snapshot time — drives the incremental refresh fast path
    journal_epoch: int = 0
    smo_state: tuple[int, int, int, int] = (0, 0, 0, 0)
    refreshes: int = 0        # fast-path refreshes applied to this mirror
    full_builds: int = 1      # full enumerations (this snapshot counts as one)
    # leaf rows re-mirrored by the latest refresh: None after a full build
    # (everything changed), an index array after the fast path — consumers
    # holding device copies update only these rows (IndexEngine.compact)
    last_touched_rows: "np.ndarray | None" = dataclasses.field(
        default=None, repr=False)

    @property
    def max_inner_height(self) -> int:
        return max(self.inner_height, 1)

    def pool_geometry(self) -> dict:
        """Static pool-shape metadata for the fused-kernel tuning layer
        (``kernels.fused_lookup.tuning.PoolGeometry.from_pools``) — plain
        ints so the core layer stays free of kernel imports."""
        return {
            "num_shards": 1,
            "slot_pool": int(self.slot_tag.shape[0]),
            "node_pool": int(self.node_base.shape[0]),
            "pa_pool": int(self.pa_keys.shape[0]),
            "pa_cap": int(self.pa_keys.shape[1]),
            "bt_pool": int(self.bt_keys.shape[0]),
            "bt_cap": int(self.bt_keys.shape[1]),
            "leaf_pool": int(self.leaf_keys.shape[0]),
            "leaf_cap": int(self.leaf_keys.shape[1]),
        }


def build_device_index(idx: Aulid) -> DeviceIndex:
    """Snapshot an AULID host index into flat device pools."""
    cfg = idx.cfg
    # ---- leaf pool, ordered by the sibling chain (rows follow key order)
    leaf_ids: list[int] = []
    b = idx.first_leaf
    while b >= 0:
        leaf_ids.append(b)
        b = idx.leaf_next.get(b, -1)
    if not leaf_ids:
        leaf_ids = []
    rows = {bid: r for r, bid in enumerate(leaf_ids)}
    L = max(len(leaf_ids), 1)
    cap = cfg.leaf_capacity
    leaf_keys = np.full((L, cap), UINT64_MAX, dtype=np.uint64)
    leaf_pay = np.zeros((L, cap), dtype=np.uint64)
    leaf_count = np.zeros(L, dtype=np.int32)
    leaf_next = np.full(L, -1, dtype=np.int32)
    for r, bid in enumerate(leaf_ids):
        c = idx.leaf_count[bid]
        leaf_keys[r, :c] = idx.leaf_keys[bid][:c]
        leaf_pay[r, :c] = idx.leaf_pay[bid][:c]
        leaf_count[r] = c
        nb = idx.leaf_next.get(bid, -1)
        leaf_next[r] = rows[nb] if nb >= 0 else -1
    last_row = rows.get(idx.last_leaf, L - 1)

    # ---- enumerate mixed nodes (preorder), packed arrays, and B+-trees
    nodes: list[MixedNode] = []
    pas: list[PackedArray] = []
    bts: list[BTreeNode] = []

    def visit(n: MixedNode) -> None:
        nodes.append(n)
        for s in sorted(n.objs):
            o = n.objs[s]
            if isinstance(o, PackedArray):
                pas.append(o)
            elif isinstance(o, BTreeNode):
                bts.append(o)
            else:
                visit(o)

    height = 0
    if idx.root is not None:
        visit(idx.root)
        height = idx.inner_height()
    node_id = {id(n): i for i, n in enumerate(nodes)}
    pa_id = {id(p): i for i, p in enumerate(pas)}
    bt_id = {id(t): i for i, t in enumerate(bts)}

    N = max(len(nodes), 1)
    S = max(sum(n.fanout for n in nodes), 1)
    node_base = np.zeros(N, dtype=np.int32)
    node_fanout = np.ones(N, dtype=np.int32)
    node_slope = np.zeros(N, dtype=np.float64)
    node_intercept = np.zeros(N, dtype=np.float64)
    node_overflow = np.full(N, -1, dtype=np.int32)
    slot_tag = np.zeros(S, dtype=np.uint8)
    slot_key = np.full(S, UINT64_MAX, dtype=np.uint64)
    slot_ptr = np.full(S, -1, dtype=np.int32)
    succ_slot = np.full(S, -1, dtype=np.int32)
    next_occ = np.full(S, -1, dtype=np.int32)

    off = 0
    for i, n in enumerate(nodes):
        node_base[i] = off
        node_fanout[i] = n.fanout
        node_slope[i] = n.model.slope
        node_intercept[i] = n.model.intercept
        off += n.fanout

    # pools (sized to actual maxima; +inf padding keeps searchsorted semantics)
    pa_cap = max([p.capacity for p in pas], default=1)
    P = max(len(pas), 1)
    pa_keys = np.full((P, pa_cap), UINT64_MAX, dtype=np.uint64)
    pa_ptrs = np.full((P, pa_cap), last_row, dtype=np.int32)
    for j, p in enumerate(pas):
        pa_keys[j, : p.count] = p.keys[: p.count]
        pa_ptrs[j, : p.count] = [rows[int(x)] for x in p.ptrs[: p.count]]
    bt_cap = max([t.count for t in bts], default=1)
    B = max(len(bts), 1)
    bt_keys = np.full((B, bt_cap), UINT64_MAX, dtype=np.uint64)
    bt_ptrs = np.full((B, bt_cap), last_row, dtype=np.int32)
    for j, t in enumerate(bts):
        es = t.entries()
        bt_keys[j, : len(es)] = [e[0] for e in es]
        bt_ptrs[j, : len(es)] = [rows[e[1]] for e in es]

    def subtree_max(n: MixedNode) -> int:
        """Max key under a mixed node. Host inserts keep PA/BT/DATA slot keys
        current but do not write a max into MIXED slots (the paper stores only
        model+address there); the mirror needs it for successor-chain tests."""
        occ = np.nonzero(n.tags != TAG_NULL)[0]
        if not occ.size:
            return 0
        s = int(occ[-1])
        if int(n.tags[s]) == TAG_MIXED:
            return subtree_max(n.objs[s])  # type: ignore[arg-type]
        return int(n.keys[s])

    # fill slots + per-node next_occ; the node's overflow continuation slot
    # (its successor entry in the ancestor chain) is threaded down recursively.
    def fill(n: MixedNode, overflow_slot: int) -> None:
        i = node_id[id(n)]
        node_overflow[i] = overflow_slot
        base = node_base[i]
        occ = np.nonzero(n.tags != TAG_NULL)[0]
        # next_occ: for every slot s, the first occupied slot >= s (in node)
        nxt = np.full(n.fanout, -1, dtype=np.int32)
        if occ.size:
            ins = np.searchsorted(occ, np.arange(n.fanout), side="left")
            valid = ins < occ.size
            nxt[valid] = base + occ[np.minimum(ins[valid], occ.size - 1)]
        next_occ[base : base + n.fanout] = nxt
        for k, s in enumerate(occ):
            s = int(s)
            g = base + s
            succ = base + int(occ[k + 1]) if k + 1 < occ.size else overflow_slot
            tag = int(n.tags[s])
            slot_tag[g] = tag
            slot_key[g] = (n.keys[s] if tag != TAG_MIXED
                           else np.uint64(subtree_max(n.objs[s])))  # type: ignore[arg-type]
            succ_slot[g] = succ
            o = n.objs.get(s)
            if tag == TAG_DATA:
                slot_ptr[g] = rows.get(int(n.ptrs[s]), last_row)
            elif tag == TAG_PA:
                slot_ptr[g] = pa_id[id(o)]
            elif tag == TAG_BT:
                slot_ptr[g] = bt_id[id(o)]
            else:  # child mixed node continues at this entry's successor
                slot_ptr[g] = node_id[id(o)]
                fill(o, succ)  # type: ignore[arg-type]

    if idx.root is not None:
        fill(idx.root, -1)

    return DeviceIndex(
        slot_tag=slot_tag, slot_key=slot_key, slot_ptr=slot_ptr,
        next_occ=next_occ, succ_slot=succ_slot,
        node_base=node_base, node_fanout=node_fanout, node_slope=node_slope,
        node_intercept=node_intercept, node_overflow_slot=node_overflow,
        pa_keys=pa_keys, pa_ptrs=pa_ptrs, bt_keys=bt_keys, bt_ptrs=bt_ptrs,
        leaf_keys=leaf_keys, leaf_pay=leaf_pay, leaf_count=leaf_count,
        leaf_next=leaf_next, root_node=0 if idx.root is not None else -1,
        last_leaf_row=last_row, last_leaf_min=np.uint64(idx.last_leaf_min),
        inner_height=height, leaf_rows=rows,
        journal_epoch=idx.journal_end, smo_state=idx.smo_state(),
    )


@dataclasses.dataclass
class StackedDeviceIndex:
    """S shard mirrors padded to uniform pool capacities and stacked along a
    leading ``(S, …)`` axis (DESIGN.md §9).

    The stacked pools feed ``lookup.lookup_batch_sharded``: a ``jax.vmap`` of
    the unrolled monolithic traversal over the shard axis.  Cross-shard scans
    do not vmap — they walk ``leaf_next_chain``, a flattened ``(S*L,)`` view
    of the per-shard sibling links in which each shard's last leaf threads
    into the first leaf of the next shard that has leaves (the shard-level
    twin of the mirror's ``succ_slot`` ancestor chain).
    """
    bounds: np.ndarray           # (S-1,) u64 inclusive upper key per shard
    dis: list[DeviceIndex]       # per-shard mirrors (epochs stay shard-local)
    # stacked pools: the DeviceIndex fields with a leading shard axis
    slot_tag: np.ndarray         # (S, Smax) u8
    slot_key: np.ndarray
    slot_ptr: np.ndarray
    next_occ: np.ndarray
    succ_slot: np.ndarray
    node_base: np.ndarray        # (S, Nmax)
    node_fanout: np.ndarray
    node_slope: np.ndarray
    node_intercept: np.ndarray
    node_overflow_slot: np.ndarray
    pa_keys: np.ndarray          # (S, Pmax, pa_cap)
    pa_ptrs: np.ndarray
    bt_keys: np.ndarray          # (S, Bmax, bt_cap)
    bt_ptrs: np.ndarray
    leaf_keys: np.ndarray        # (S, Lmax, leaf_cap)
    leaf_pay: np.ndarray
    leaf_count: np.ndarray       # (S, Lmax)
    leaf_next: np.ndarray        # (S, Lmax) shard-local rows, -1 at shard end
    meta: np.ndarray             # (S, 2) [root_node, last_leaf_row]
    last_leaf_min: np.ndarray    # (S,) u64
    leaf_next_chain: np.ndarray  # (S*Lmax,) global rows, crosses shards
    # pool epoch (DESIGN.md §11): bumped on every shard install / full
    # re-stack, so consumers can tell "same object, new contents" apart —
    # the double-buffered engines swap epochs atomically between steps
    epoch: int = 0

    @property
    def num_shards(self) -> int:
        return len(self.dis)

    @property
    def max_inner_height(self) -> int:
        return max(max(di.max_inner_height for di in self.dis), 1)

    def pool_geometry(self) -> dict:
        """Per-shard padded pool shapes (the stacked twin of
        :meth:`DeviceIndex.pool_geometry`)."""
        return {
            "num_shards": self.num_shards,
            "slot_pool": int(self.slot_tag.shape[1]),
            "node_pool": int(self.node_base.shape[1]),
            "pa_pool": int(self.pa_keys.shape[1]),
            "pa_cap": int(self.pa_keys.shape[2]),
            "bt_pool": int(self.bt_keys.shape[1]),
            "bt_cap": int(self.bt_keys.shape[2]),
            "leaf_pool": int(self.leaf_keys.shape[1]),
            "leaf_cap": int(self.leaf_keys.shape[2]),
        }


def placeholder_device_index() -> DeviceIndex:
    """An empty shard-slot mirror for shard-count padding (DESIGN.md §12):
    all pools are one sentinel-filled row, ``root_node=-1`` (no traversal),
    and ``leaf_rows`` is empty so the successor chain skips it.  Slots padded
    with these never receive queries — the padded boundary table routes every
    key at or below the last real shard — but their pool contents are valid
    sentinels anyway."""
    return DeviceIndex(
        slot_tag=np.zeros(1, dtype=np.uint8),
        slot_key=np.full(1, UINT64_MAX, dtype=np.uint64),
        slot_ptr=np.full(1, -1, dtype=np.int32),
        next_occ=np.full(1, -1, dtype=np.int32),
        succ_slot=np.full(1, -1, dtype=np.int32),
        node_base=np.zeros(1, dtype=np.int32),
        node_fanout=np.ones(1, dtype=np.int32),
        node_slope=np.zeros(1, dtype=np.float64),
        node_intercept=np.zeros(1, dtype=np.float64),
        node_overflow_slot=np.full(1, -1, dtype=np.int32),
        pa_keys=np.full((1, 1), UINT64_MAX, dtype=np.uint64),
        pa_ptrs=np.zeros((1, 1), dtype=np.int32),
        bt_keys=np.full((1, 1), UINT64_MAX, dtype=np.uint64),
        bt_ptrs=np.zeros((1, 1), dtype=np.int32),
        leaf_keys=np.full((1, 1), UINT64_MAX, dtype=np.uint64),
        leaf_pay=np.zeros((1, 1), dtype=np.uint64),
        leaf_count=np.zeros(1, dtype=np.int32),
        leaf_next=np.full(1, -1, dtype=np.int32),
        root_node=-1, last_leaf_row=0, last_leaf_min=UINT64_MAX,
        inner_height=0, leaf_rows={},
    )


_STACK_2D = [("slot_tag", 0), ("slot_key", UINT64_MAX), ("slot_ptr", -1),
             ("next_occ", -1), ("succ_slot", -1), ("node_base", 0),
             ("node_fanout", 1), ("node_slope", 0.0), ("node_intercept", 0.0),
             ("node_overflow_slot", -1), ("leaf_count", 0), ("leaf_next", -1)]
_STACK_3D = [("pa_keys", UINT64_MAX), ("pa_ptrs", 0), ("bt_keys", UINT64_MAX),
             ("bt_ptrs", 0), ("leaf_keys", UINT64_MAX), ("leaf_pay", 0)]


def _pad_to(a: np.ndarray, shape: tuple, fill) -> np.ndarray:
    out = np.full(shape, fill, dtype=a.dtype)
    out[tuple(slice(0, d) for d in a.shape)] = a
    return out


def _chain_rows(dis: list[DeviceIndex], Lmax: int) -> np.ndarray:
    """Precompute the shard-successor leaf chain over the flattened (S*L,)
    row space: within a shard the local sibling links (offset by s*Lmax);
    each shard's last leaf continues at row 0 (build order starts at
    ``first_leaf``) of the next shard that has leaves; leafless padding
    shards are skipped.  -1 only at the global end."""
    S = len(dis)
    chain = np.full(S * Lmax, -1, dtype=np.int32)
    first_with_leaves = [-1] * S  # global first-leaf row of the next shard
    nxt = -1
    for s in range(S - 1, -1, -1):
        first_with_leaves[s] = nxt
        if dis[s].leaf_rows:
            nxt = s * Lmax
    for s, di in enumerate(dis):
        L = di.leaf_next.shape[0]
        local = di.leaf_next.astype(np.int32)
        rows = np.where(local >= 0, s * Lmax + local, -1)
        # the shard's chain end (its last leaf) threads into the successor
        if di.leaf_rows:
            rows[di.last_leaf_row] = first_with_leaves[s]
        else:
            rows[:] = first_with_leaves[s]  # padding rows skip ahead
        chain[s * Lmax : s * Lmax + L] = rows
    return chain


def stacked_pool_caps(sdi: StackedDeviceIndex) -> dict:
    """Per-shard pool capacities of an existing stack (shape minus the
    leading shard axis).  Pass as ``min_caps`` to :func:`stack_device_indexes`
    to ratchet capacities: a rebuild then never SHRINKS a pool dim, so the
    jitted read shapes only ever change when a pool genuinely outgrows its
    pad — a split/merge install that adopts a freshly stacked mirror keeps
    every compile warm (DESIGN.md §12)."""
    return {f: getattr(sdi, f).shape[1:] for f, _ in _STACK_2D + _STACK_3D}


def stack_device_indexes(dis: list[DeviceIndex], bounds: np.ndarray,
                         min_shards: int = 0,
                         min_caps: dict | None = None) -> StackedDeviceIndex:
    """Pad all shard mirrors to uniform pool capacities and stack them into
    ``(S, …)``-leading arrays (DESIGN.md §9).  Padding reuses the pools' own
    sentinel values (+inf keys, -1 links, NULL tags) so a vmapped per-shard
    traversal behaves exactly as it would over the unpadded mirror.

    Pool-count capacities (leading dims) round up to the power of two above
    a 25% headroom: the slack absorbs shard growth (``restack_shard`` stays
    in place across compactions) and keeps the stacked shapes — and
    therefore the jitted read path's compiles — stable across full
    re-stacks.  Fixed per-entry capacities (e.g. ``leaf_capacity``) round to
    a plain power of two.

    ``min_shards`` pads the leading shard axis itself to at least that many
    slots (DESIGN.md §12): trailing slots hold :func:`placeholder_device_index`
    mirrors and the boundary table is UINT64_MAX-padded, so ``searchsorted``
    (and the fused kernel's ``count(bounds < q)`` twin) routes every real key
    to a real shard and the padding slots never see a query.  Repartitioning
    engines size ``min_shards`` pow2+headroom above the live shard count so a
    split/merge within capacity keeps every stacked shape — and every jitted
    read compile — unchanged.  The default (0) preserves exact-fit stacking.

    ``min_caps`` (see :func:`stacked_pool_caps`) floors each pool dim so a
    rebuild never shrinks a shape the read path already compiled for."""
    assert dis, "need at least one shard mirror"
    assert len(bounds) == len(dis) - 1, (len(bounds), len(dis))
    if min_shards > len(dis):
        pad = min_shards - len(dis)
        dis = list(dis) + [placeholder_device_index() for _ in range(pad)]
        bounds = np.concatenate([
            np.asarray(bounds, dtype=np.uint64),
            np.full(pad, UINT64_MAX, dtype=np.uint64)])

    def dim_cap(f: str, d: int) -> int:
        m = max(getattr(di, f).shape[d] for di in dis)
        cap = next_pow2(m + m // 4 + 1 if d == 0 else m)
        if min_caps is not None and f in min_caps:
            cap = max(cap, int(min_caps[f][d]))
        return cap

    shapes = {f: tuple(dim_cap(f, d)
                       for d in range(getattr(dis[0], f).ndim))
              for f, _ in _STACK_2D + _STACK_3D}
    stacked = {f: np.stack([_pad_to(getattr(di, f), shapes[f], fill)
                            for di in dis])
               for f, fill in _STACK_2D + _STACK_3D}
    Lmax = shapes["leaf_keys"][0]
    return StackedDeviceIndex(
        bounds=np.asarray(bounds, dtype=np.uint64), dis=list(dis), **stacked,
        meta=np.array([[di.root_node, di.last_leaf_row] for di in dis],
                      dtype=np.int32),
        last_leaf_min=np.array([di.last_leaf_min for di in dis],
                               dtype=np.uint64),
        leaf_next_chain=_chain_rows(dis, Lmax),
    )


def rechain_stacked(sdi: StackedDeviceIndex) -> None:
    """Recompute the cross-shard successor chain over all shards — O(S·Lmax),
    so callers re-padding several shards in one step pass ``rechain=False``
    to :func:`restack_shard` and call this once afterwards."""
    sdi.leaf_next_chain[:] = _chain_rows(sdi.dis, sdi.leaf_keys.shape[1])


def restack_shard(sdi: StackedDeviceIndex, s: int,
                  rechain: bool = True) -> bool:
    """Re-pad shard ``s``'s (refreshed) mirror into the stacked pools in
    place.  Returns False when any pool outgrew its padded capacity — the
    caller must then re-stack all shards (``stack_device_indexes``); cold
    shards' slices (and their mirrors' snapshot epochs) are untouched either
    way, which is what keeps compaction stalls shard-local."""
    di = sdi.dis[s]
    for f, _ in _STACK_2D + _STACK_3D:
        if any(a > b for a, b in zip(getattr(di, f).shape,
                                     getattr(sdi, f).shape[1:])):
            return False
    for f, fill in _STACK_2D + _STACK_3D:
        dst = getattr(sdi, f)
        dst[s] = _pad_to(getattr(di, f), dst.shape[1:], fill)
    sdi.meta[s] = (di.root_node, di.last_leaf_row)
    sdi.last_leaf_min[s] = di.last_leaf_min
    sdi.epoch += 1
    if rechain:
        rechain_stacked(sdi)
    return True


def pad_shard_slices(sdi: StackedDeviceIndex,
                     di: DeviceIndex) -> "dict[str, np.ndarray] | None":
    """Pad one (refreshed) shard mirror to ``sdi``'s stacked pool shapes
    WITHOUT touching ``sdi`` — the build stage of the double-buffered
    compaction lifecycle (DESIGN.md §11), safe to run on a background thread
    while the stacked pools keep serving the old epoch.  Returns the padded
    per-field slices (plus the shard's meta row), or None when any pool
    outgrew its padded capacity (the caller must then full-re-stack at swap
    time)."""
    for f, _ in _STACK_2D + _STACK_3D:
        if any(a > b for a, b in zip(getattr(di, f).shape,
                                     getattr(sdi, f).shape[1:])):
            return None
    out = {f: _pad_to(getattr(di, f), getattr(sdi, f).shape[1:], fill)
           for f, fill in _STACK_2D + _STACK_3D}
    out["meta"] = np.array([di.root_node, di.last_leaf_row], dtype=np.int32)
    out["last_leaf_min"] = np.uint64(di.last_leaf_min)
    return out


def install_shard_slices(sdi: StackedDeviceIndex, s: int, di: DeviceIndex,
                         slices: dict) -> None:
    """Install slices prepared by :func:`pad_shard_slices` for shard ``s``
    into the stacked pools — the swap stage of the lifecycle, run between
    engine steps.  Shapes must match ``sdi`` (the caller re-validates when a
    concurrent full re-stack may have changed them).  No rechain: callers
    installing several shards call :func:`rechain_stacked` once."""
    sdi.dis[s] = di
    for f, _ in _STACK_2D + _STACK_3D:
        getattr(sdi, f)[s] = slices[f]
    sdi.meta[s] = slices["meta"]
    sdi.last_leaf_min[s] = slices["last_leaf_min"]
    sdi.epoch += 1


def refresh_device_index(idx: Aulid, di: DeviceIndex) -> DeviceIndex:
    """Bring a mirror up to date with the host, incrementally when possible.

    Fast path (DESIGN.md §3): when no structure-modifying operation happened
    since ``di`` was snapshotted (leaf splits, node creates, Adjusts, and leaf
    unlinks all change the SMO fingerprint), every journaled write only edited
    the *content* of an existing leaf block — so re-mirroring the touched leaf
    rows (plus the metanode's ``last_leaf_min``) is exact.  Cost is
    O(touched leaves × leaf_capacity) instead of the full-tree O(n)
    enumeration; the mirror is mutated in place and returned, with the
    touched rows recorded in ``last_touched_rows`` so device-side copies can
    be patched instead of re-uploaded.

    Anything structural falls back to :func:`build_device_index`.

    Either way the consumed journal prefix is truncated (the journal would
    otherwise grow without bound under sustained writes).  Epochs are
    ABSOLUTE journal positions (``Aulid.journal_base`` tracks truncation),
    so a different mirror snapshotted at an older epoch sees its entries
    are gone (``journal_epoch < journal_base``) and takes the full-build
    path instead of silently skipping the truncated writes.
    """
    def consume() -> None:
        idx.journal_base += len(idx.journal)
        idx.journal.clear()

    def full() -> DeviceIndex:
        consume()
        ndi = build_device_index(idx)
        ndi.refreshes = di.refreshes
        ndi.full_builds = di.full_builds + 1
        return ndi

    start = di.journal_epoch - idx.journal_base
    if start < 0 or idx.journal_end < di.journal_epoch \
            or idx.smo_state() != di.smo_state:
        return full()            # bulkload, SMO, or truncated-away entries
    if start == len(idx.journal):
        di.last_touched_rows = np.empty(0, dtype=np.int64)
        return di                # already current: no-op
    touched = {e.leaf for e in idx.journal[start:]}
    if not touched.issubset(di.leaf_rows.keys()):
        return full()
    cap = di.leaf_keys.shape[1]
    rows = []
    for bid in touched:
        r = di.leaf_rows[bid]
        c = idx.leaf_count[bid]
        di.leaf_keys[r, :c] = idx.leaf_keys[bid][:c]
        di.leaf_keys[r, c:] = UINT64_MAX
        di.leaf_pay[r, :c] = idx.leaf_pay[bid][:c]
        di.leaf_pay[r, c:] = 0
        di.leaf_count[r] = c
        rows.append(r)
        assert c <= cap
    di.last_leaf_min = np.uint64(idx.last_leaf_min)
    consume()                    # bounded journal (see docstring)
    di.journal_epoch = idx.journal_base
    di.refreshes += 1
    di.last_touched_rows = np.array(sorted(rows), dtype=np.int64)
    return di
