"""Mixed read/write serving engine over AULID + the incremental device mirror
— the port of ``src/repro/serving/index_engine.py`` onto one CUDA device.

The host logic is the reference's, line for line; the device hooks call the
port (``core.lookup``): point reads launch K1 (``fused_lookup``), the
step's write batch merges into the device overlay pack through K2
(``overlay_merge``), scans run in plain PyTorch from K1's start leaf.  The
engine runs on ``cuda:0`` unless built with ``device="cpu"``, where the
kernels' plain versions serve instead (``stats()["read_backend"]`` names the
path: ``"cuda"`` or ``"torch"``).  Results move to the host with
``.cpu().numpy()``, a sync that counts in the step time.

Request flow per :meth:`step`:

1. drain the queue, partitioning into writes and reads (step-level
   consistency: every write queued before the step is visible to every read
   executed in it — the oracle the property tests assert against);
2. apply writes to the host ``Aulid`` (which journals them) *and* to the
   ``DeltaOverlay`` — the device mirror itself is untouched;
3. compaction policy: once ``len(overlay) >= gamma * n`` the overlay is
   folded into a fresh snapshot via ``refresh_device_index`` (the journal
   fast path re-mirrors only touched leaf rows when no SMO happened) and
   cleared — mirroring AULID's own Adjust criterion of amortizing structural
   work against a fraction of covered data (paper §4.4);
4. execute all point reads as ONE fused ``lookup_batch_overlay`` device batch
   and scans as one ``scan_batch_overlay`` batch per power-of-two scan-length
   bucket (results slice to the requested count).

Write semantics are unique-key upserts (``insert`` overwrites an existing
key's payload; ``delete`` removes the key) so host, overlay, and device views
agree under arbitrary interleavings — AULID's duplicate-key multiset remains
available on the host path directly.

The per-index state (host index, mirror, overlay, compaction counters) lives
in :class:`IndexShard` so the range-sharded engine (``sharded_engine.py``,
DESIGN.md §9) reuses the same write/compaction lifecycle per shard while this
engine stays the S=1 special case.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Optional

import numpy as np
import torch

from ..core.aulid import Aulid
from ..core.delta_overlay import DeltaOverlay, next_pow2
from ..core.device_index import (DeviceIndex, build_device_index,
                                 refresh_device_index)
from ..core.keys import bits_from_tensor, keys_from_tensor, keys_to_tensor
from ..core.lookup import (device_arrays, lookup_batch_overlay,
                           merge_overlay_pack, overlay_arrays,
                           overlay_arrays_merged, scan_batch_overlay,
                           update_leaf_rows)
from ..device import resolve
from .scan_rows import ScanRows
from .tracing import Tracer

MIN_SCAN_BUCKET = 8

# shared background-build pool of the double-buffered compaction path
# (DESIGN.md §11); one per process — builds are host-CPU + transfer bound and
# each engine serializes its own swaps, so a small pool suffices
_COMPACT_POOL = None


def compaction_executor():
    global _COMPACT_POOL
    if _COMPACT_POOL is None:
        import concurrent.futures
        _COMPACT_POOL = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="aulid-compact")
    return _COMPACT_POOL


def scan_bucket(count: int) -> int:
    """Power-of-two scan-length bucket: results are computed at the bucket
    size and sliced back to the requested count (the reference's buckets,
    kept so both serve the same shapes)."""
    return max(MIN_SCAN_BUCKET, next_pow2(int(count)))


def pad_queries(keys: list[int]) -> np.ndarray:
    """Pad a read batch to the next power of two with u64-max sentinel keys
    (results past the real count are discarded) — the same sentinels flow
    through the port as through the reference."""
    q = np.full(next_pow2(len(keys)), 0xFFFFFFFFFFFFFFFF, dtype=np.uint64)
    q[: len(keys)] = keys
    return q


@dataclasses.dataclass
class IndexRequest:
    rid: int
    op: str                    # "get" | "insert" | "delete" | "scan"
    key: int
    payload: int = 0
    count: int = 0             # scan length
    result: object = None   # get: payload|None; delete: bool; scan: ScanRows
    done: bool = False


@dataclasses.dataclass
class IndexShard:
    """Per-index serving state: host structure, frozen device mirror, write
    overlay, and compaction counters (DESIGN.md §3 lifecycle, §9 sharding).

    ``arrs``/``ov_arrs`` are the device copies the monolithic engine serves
    from; the sharded engine leaves them ``None`` and serves from the stacked
    pools instead (``with_arrays=False``), so a shard compaction only touches
    its own slice of the stack.

    ``frozen_overlay``/``pending`` are the double-buffered compaction state
    (DESIGN.md §11): while a background build is in flight the pre-freeze
    overlay stays merged into reads, the host index is read-only, and writes
    land in the (fresh) live overlay plus a pending log replayed at swap."""
    idx: Aulid
    overlay: DeltaOverlay
    di: DeviceIndex
    arrs: Optional[dict] = None
    ov_arrs: Optional[dict] = None
    compactions: int = 0
    frozen_overlay: Optional[DeltaOverlay] = None
    pending: list = dataclasses.field(default_factory=list)
    # device-resident write path (DESIGN.md §14): whether writes merge into
    # the device pack (False = always reseed from host, the old full-repack
    # path), the (live uid, frozen uid) structure the current pack was seeded
    # against, and the write-path cost counters the benchmarks report
    ov_merge: bool = False
    ov_struct: Optional[tuple] = None
    write_h2d_bytes: int = 0
    overlay_merges: int = 0
    overlay_reseeds: int = 0
    device: Optional[torch.device] = None
    # the owning ``IndexEngine``'s tracer while it traces (tracing.py)
    tracer: Optional[Tracer] = None

    @classmethod
    def wrap(cls, idx: Aulid, gamma: float, with_arrays: bool = True,
             device=None) -> "IndexShard":
        # capacity floor ~= compaction threshold: one pack shape per lifetime
        overlay = DeltaOverlay.for_threshold(gamma * max(idx.n_items, 1))
        di = build_device_index(idx)
        sh = cls(idx=idx, overlay=overlay, di=di, device=resolve(device))
        if with_arrays:
            sh.arrs = device_arrays(di, sh.device)
            sh.ov_arrs = overlay_arrays(overlay, sh.device)
            sh.ov_struct = (overlay.uid, 0)   # pack seeded (empty, synced)
        return sh

    # ---------------------------------------------------------------- writes
    def apply_write(self, op: str, key: int, payload: int = 0):
        """Host + overlay write (unique-key upsert semantics, module
        docstring).  Returns the request result (True / delete outcome).

        While a background compaction is in flight the host index is
        read-only (the build thread is walking it), so writes defer: they
        land in the live overlay immediately (reads see them this step) and
        in the pending log replayed at ``finish_swap``.  Results are computed
        overlay-first so they match the synchronous path exactly."""
        if self.frozen_overlay is not None:
            self.pending.append((op, key, payload))
            if op == "insert":
                self.overlay.record_insert(key, payload)
                return True
            existed = self._key_live(key)
            self.overlay.record_delete(key)
            return existed
        if op == "insert":
            if not self.idx.update(key, payload):
                self.idx.insert(key, payload)
            self.overlay.record_insert(key, payload)
            return True
        self.overlay.record_delete(key)
        return self.idx.delete(key)

    def _key_live(self, key: int) -> bool:
        """Whether ``key`` currently exists in the served view — the deferred
        twin of ``idx.delete``'s return value: live overlay, then frozen
        overlay, then the (frozen) host index."""
        for ov in (self.overlay, self.frozen_overlay):
            if ov is not None:
                ent = ov.get(key)
                if ent is not None:
                    return not ent[1]
        return self.idx.lookup(key) is not None

    # ------------------------------------------------------------ compaction
    def needs_compaction(self, gamma: float) -> bool:
        return len(self.overlay) >= gamma * max(self.idx.n_items, 1)

    def freeze(self, count: bool = True) -> DeltaOverlay:
        """Freeze the overlay for a double-buffered compaction (DESIGN.md
        §11): reads keep merging it over the old snapshot, writes move to a
        fresh spawn, and the host index is read-only until ``finish_swap``.
        Counted as this shard's compaction NOW (at the decision point), so
        compaction counters are deterministic across sync/async modes.
        Repartition builds reuse the same freeze window but are counted by
        the engine's split/merge counters instead (``count=False``)."""
        assert self.frozen_overlay is None, "compaction already in flight"
        self.frozen_overlay = self.overlay
        self.overlay = self.frozen_overlay.spawn_empty()
        if count:
            self.compactions += 1
        return self.frozen_overlay

    def finish_swap(self, new_di: DeviceIndex) -> None:
        """Retire the frozen overlay and replay the pending log into the
        host index (the writes deferred while the build ran).  Replayed
        writes re-journal and fold at the NEXT compaction; the live overlay
        already serves them to reads, so the served view never moves."""
        self.di = new_di
        self.frozen_overlay = None
        pending, self.pending = self.pending, []
        for op, key, payload in pending:
            if op == "insert":
                if not self.idx.update(key, payload):
                    self.idx.insert(key, payload)
            else:
                self.idx.delete(key)

    def abort_swap(self) -> None:
        """Roll back a freeze whose background build FAILED (DESIGN.md §12):
        the old mirror stays live, the pending log is replayed into the host
        index (no lost writes), and the frozen overlay's entries are folded
        back under the live overlay — they are in the host index but not in
        the old mirror, so they must stay overlay-visible until a later
        compaction succeeds.  The served view never moves."""
        assert self.frozen_overlay is not None, "no build in flight"
        frozen, self.frozen_overlay = self.frozen_overlay, None
        self.overlay.merge_under(frozen)
        pending, self.pending = self.pending, []
        for op, key, payload in pending:
            if op == "insert":
                if not self.idx.update(key, payload):
                    self.idx.insert(key, payload)
            else:
                self.idx.delete(key)

    def compact(self) -> None:
        """Fold the overlay into a fresh snapshot and clear it (DESIGN.md §3).

        After a fast-path refresh only the touched leaf rows are re-uploaded
        (``update_leaf_rows``); a full rebuild re-transfers every pool.  When
        this shard serves from a stacked mirror (``arrs is None``) the device
        update is the owner engine's job (``restack_shard``)."""
        assert self.frozen_overlay is None, \
            "sync compact during in-flight compaction (drain first)"
        tr = self.tracer
        if tr is not None:
            tr.open("compact")
        old = self.di
        self.di = refresh_device_index(self.idx, old)
        if self.arrs is not None:
            if self.di is old:
                self.arrs = update_leaf_rows(self.arrs, self.di)
            else:
                self.arrs = device_arrays(self.di, self.device)
        self.overlay.clear()
        if self.ov_arrs is not None:
            self.refresh_overlay_arrays()
        self.compactions += 1
        if tr is not None:
            tr.close()

    def refresh_overlay_arrays(self) -> None:
        """Sync the device overlay pack with this step's writes
        (DESIGN.md §14).

        Delta path (steady state): the device pack is the source of truth
        between compactions — drain the live overlay's pending writes, ship
        only that sorted batch (O(batch) H2D), and fold it in on device via
        the bound overlay-merge backend.  The path is valid exactly while
        the (live uid, frozen uid) structure beneath the pack is unchanged:
        a freeze merely relabels content the pack already merges (the
        frozen∪live view is invariant under the relabeling), and batch
        writes stay newest, so last-writer-wins keeps the pack exact.

        Reseed path (ownership handoff back to the host dicts): any uid
        change — freeze, finish_swap, abort_swap, or a clear() (which takes
        a fresh uid) — rebuilds the pack from the host state, and
        ``mark_synced`` discards the now-moot pending deltas.

        Both paths keep the two device packs of ``merge_overlay_pack``
        (served and spare): a merge writes into the spare, a reseed uploads
        into it."""
        tr = self.tracer
        struct = (self.overlay.uid,
                  self.frozen_overlay.uid if self.frozen_overlay else 0)
        if (self.ov_merge and self.ov_arrs is not None
                and struct == self.ov_struct):
            if tr is not None:
                tr.open("overlay.merge")
            batch = self.overlay.take_batch()
            if batch[0].size:
                live = self.overlay_live()
                cap_out = max(int(self.ov_arrs["ov_pack"].shape[1]),
                              next_pow2(live))
                self.ov_arrs, nbytes = merge_overlay_pack(
                    self.ov_arrs, batch, cap_out, live)
                self.write_h2d_bytes += nbytes
                self.overlay_merges += 1
            if tr is not None:
                tr.close()
            return
        if tr is not None:
            tr.open("overlay.reseed")
        self.overlay.mark_synced()
        if self.frozen_overlay is not None:
            self.frozen_overlay.mark_synced()
            self.ov_arrs = overlay_arrays_merged(
                self.frozen_overlay, self.overlay, self.device,
                prev=self.ov_arrs)
        else:
            self.ov_arrs = overlay_arrays(self.overlay, self.device,
                                          prev=self.ov_arrs)
        self.ov_struct = struct
        self.overlay_reseeds += 1
        self.write_h2d_bytes += int(self.ov_arrs["ov_pack"].nbytes)
        if tr is not None:
            tr.close()

    def overlay_live(self) -> int:
        """Upper bound on live served-overlay entries (scan ``ov_bound``):
        counts the frozen overlay too while a compaction is in flight."""
        n = len(self.overlay)
        if self.frozen_overlay is not None:
            n += len(self.frozen_overlay)
        return n


class BaseIndexEngine:
    """Request admission, fused-batch read serving, and the step's spans
    (``tracing.py``) shared by the monolithic and range-sharded engines
    (DESIGN.md §4, §9).

    Subclasses bind the read entry points (``self._lookup`` /
    ``self._scan``, called with the device operands `_snap()` / `_ov()`),
    implement the write/compaction path (`_apply_write`, `_after_writes`)
    and name the host indexes the write span counts over (`_indexes`)."""

    def __init__(self, device=None):
        self.device = resolve(device)
        self.queue: list[IndexRequest] = []
        self.next_rid = 0
        # serving stats
        self.steps = 0
        self.reads_served = 0
        self.writes_applied = 0
        self.tracer: Optional[Tracer] = None
        # first-seen read specializations — static args (count bucket /
        # ov_bound / height) PLUS every device operand's shape: the
        # reference's jit cache key, kept so both engines count the same
        # shape changes (the port compiles nothing per shape).
        self._read_shapes: set[tuple] = set()
        self.read_shape_misses = 0

    def _note_read_shape(self, *statics) -> None:
        sig = tuple(sorted(
            (name, k, tuple(v.shape))
            for name, ops in (("snap", self._snap()), ("ov", self._ov()))
            for k, v in ops.items() if hasattr(v, "shape")))
        key = statics + (self._height(), sig)
        if key not in self._read_shapes:
            self._read_shapes.add(key)
            self.read_shape_misses += 1

    # ------------------------------------------------------------- admission
    def submit(self, op: str, key: int, payload: int = 0,
               count: int = 0) -> IndexRequest:
        assert op in ("get", "insert", "delete", "scan"), op
        req = IndexRequest(self.next_rid, op, int(key), int(payload),
                           int(count))
        self.next_rid += 1
        self.queue.append(req)
        return req

    def get(self, key: int) -> IndexRequest:
        return self.submit("get", key)

    def insert(self, key: int, payload: int) -> IndexRequest:
        return self.submit("insert", key, payload)

    def delete(self, key: int) -> IndexRequest:
        return self.submit("delete", key)

    def scan(self, key: int, count: int = 100) -> IndexRequest:
        return self.submit("scan", key, count=count)

    # --------------------------------------------------------------- tracing
    def start_trace(self) -> Tracer:
        """Keep the steps' spans and counters and the submit stamps of one
        request in ``tracing.STAMP_EVERY`` on average from now on
        (``tracing.py``); start a profiler first to share its clock."""
        if self.tracer is not None:
            raise RuntimeError("the engine is already tracing")
        tr = Tracer()
        tr.anchor()
        self.submit = tr.stamped(type(self).submit.__get__(self))
        gc.callbacks.append(tr.collecting)
        self.tracer = tr
        return tr

    def stop_trace(self) -> Tracer:
        """Stop tracing; returns the tracer (``export()`` gives its
        readings)."""
        tr = self.tracer
        if tr is None:
            raise RuntimeError("the engine is not tracing")
        del self.submit
        gc.callbacks.remove(tr.collecting)
        self.tracer = None
        tr.stop_ns = time.perf_counter_ns()
        return tr

    def _index_counts(self) -> dict:
        """The host indexes' always-on counters, summed (``writes.host``'s
        deltas)."""
        out = dict.fromkeys(("block_reads", "block_writes", "leaf_walks",
                             "null_scans", "null_scan_slots"), 0)
        devs = {}
        for idx in self._indexes():
            devs[id(idx.dev)] = idx.dev
            out["leaf_walks"] += idx.leaf_walks
            out["null_scans"] += idx.null_scans
            out["null_scan_slots"] += idx.null_scan_slots
        for dev in devs.values():
            out["block_reads"] += dev.stats.reads
            out["block_writes"] += dev.stats.writes
        return out

    # ---------------------------------------------------- subclass bindings
    def _begin_step(self) -> None:
        """Epoch-swap point of the double-buffered compaction lifecycle
        (DESIGN.md §11): engines that build mirrors in the background install
        any finished build here — between request batches, inside the step
        timer (the swap cost is real serving cost), never mid-batch — so a
        read batch only ever sees one epoch's pools."""

    def _end_step(self) -> None:
        """Step-teardown hook, run after the step's last read batch: engines
        with a versioned boundary table release the version they pinned in
        ``_begin_step`` here (DESIGN.md §12)."""

    def _snap(self) -> dict:
        """Device snapshot operand of the read entry points."""
        raise NotImplementedError

    def _ov(self) -> dict:
        """Device overlay operand of the read entry points."""
        raise NotImplementedError

    def _height(self) -> int:
        raise NotImplementedError

    def _overlay_live(self) -> int:
        """Live overlay entries — the scan's hideable-candidate bound."""
        raise NotImplementedError

    def _apply_write(self, req: IndexRequest) -> None:
        raise NotImplementedError

    def _after_writes(self) -> None:
        """Compaction policy + overlay device-pack refresh."""
        raise NotImplementedError

    def _indexes(self) -> list:
        """The host ``Aulid`` indexes the writes go to."""
        raise NotImplementedError

    # ------------------------------------------------------------- read path
    def _queries(self, keys: list[int]) -> torch.Tensor:
        return keys_to_tensor(pad_queries(keys), self.device)

    def _serve_gets(self, gets: list[IndexRequest]) -> None:
        tr = self.tracer
        if tr is not None:
            tr.open("gets")
            tr.open("gets.queries")
        q = self._queries([r.key for r in gets])
        self._note_read_shape("get", q.shape[0])
        if tr is not None:
            tr.lap("gets.launch")
        pay, found, _ = self._lookup(self._snap(), self._ov(), q,
                                     height=self._height())
        if tr is not None:
            tr.lap("gets.fetch")
        pay = bits_from_tensor(pay)
        found = found.cpu().numpy()
        if tr is not None:
            tr.lap("gets.fill")
        for i, r in enumerate(gets):
            r.result = int(pay[i]) if bool(found[i]) else None
            r.done = True
        self.reads_served += len(gets)
        if tr is not None:
            tr.close()
            tr.close()

    def _serve_scans(self, scans: list[IndexRequest]) -> None:
        by_bucket: dict[int, list[IndexRequest]] = {}
        for r in scans:
            by_bucket.setdefault(scan_bucket(r.count or 100), []).append(r)
        # live-overlay bound (pow2-bucketed): the scan's unrolled leaf walk
        # scales with how full the overlay IS, not its padded capacity
        ov_bound = next_pow2(max(self._overlay_live(), MIN_SCAN_BUCKET))
        tr = self.tracer
        for bucket, grp in sorted(by_bucket.items()):
            if tr is not None:
                tr.open("scans")
                tr.open("scans.queries")
            q = self._queries([r.key for r in grp])
            self._note_read_shape("scan", q.shape[0], bucket, ov_bound)
            if tr is not None:
                tr.lap("scans.launch")
            ks, ps, valid = self._scan(self._snap(), self._ov(), q,
                                       count=bucket, height=self._height(),
                                       ov_bound=ov_bound)
            if tr is not None:
                tr.lap("scans.fetch")
            ks, ps = keys_from_tensor(ks), bits_from_tensor(ps)
            valid = valid.cpu().numpy()
            if tr is not None:
                tr.lap("scans.pairs")
            # each request's rows copied out of the batch's: a kept answer
            # holds its own rows, not the (Q, bucket) fetch
            ns = np.minimum(valid.sum(1)[:len(grp)],
                            [r.count or 100 for r in grp]).tolist()
            for r, k, p, n in zip(grp, ks, ps, ns):
                r.result = ScanRows(k[:n].copy(), p[:n].copy())
                r.done = True
            self.reads_served += len(grp)
            if tr is not None:
                tr.close(rows=sum(ns))
                tr.close()

    # ------------------------------------------------------------------ step
    def step(self) -> int:
        """Drain the queue: writes (host + overlay), compaction policy, then
        all reads as fused device batches. Returns requests completed."""
        if not self.queue:
            return 0
        tr = self.tracer
        if tr is not None:
            tr.step = self.steps
            tr.open("step")
            tr.open("step.begin")
        self._begin_step()
        if tr is not None:
            tr.lap("step.partition")
        batch, self.queue = self.queue, []
        writes = [r for r in batch if r.op in ("insert", "delete")]
        gets = [r for r in batch if r.op == "get"]
        scans = [r for r in batch if r.op == "scan"]
        if tr is not None:
            tr.close()
        if writes:
            if tr is not None:
                tr.open("writes.host", self._index_counts())
            for r in writes:
                self._apply_write(r)
            if tr is not None:
                tr.close(self._index_counts(), writes=len(writes))
                tr.open("writes.after")
            self._after_writes()
            if tr is not None:
                tr.close()
        if gets:
            self._serve_gets(gets)
        if scans:
            self._serve_scans(scans)
        self._end_step()
        self.steps += 1
        if tr is not None:
            tr.close(rid_first=batch[0].rid, rid_last=batch[-1].rid,
                     writes=len(writes), gets=len(gets), scans=len(scans))
        return len(batch)

    def run(self) -> int:
        done = 0
        while self.queue:
            done += self.step()
        return done

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        return {
            "steps": self.steps,
            "reads_served": self.reads_served,
            "writes_applied": self.writes_applied,
            "read_shape_misses": self.read_shape_misses,
        }


class IndexEngine(BaseIndexEngine):
    """Batching engine for mixed get/insert/delete/scan over one index.

    ``async_compact=True`` enables the double-buffered compaction lifecycle
    (DESIGN.md §11): crossing the gamma threshold freezes the overlay and
    builds the refreshed mirror on a background thread while steps keep
    serving old-snapshot + frozen-overlay reads; the finished build installs
    at the next step boundary.  Default off — the monolithic engine is the
    S=1 reference the equivalence tests pin down, and the sharded engine is
    where stalls actually dominate.

    ``device`` defaults to ``cuda:0`` and raises without CUDA; pass
    ``device="cpu"`` for the plain PyTorch path."""

    def __init__(self, idx: Aulid, *, device=None, gamma: float = 0.05,
                 auto_compact: bool = True, async_compact: bool = False,
                 overlay_merge: bool = True):
        super().__init__(device)
        # the tensors' device picks the path: K1/K2 on cuda, their plain
        # versions on cpu; scans are plain PyTorch either way
        self.read_backend = "cuda" if self.device.type == "cuda" else "torch"
        self._lookup = lookup_batch_overlay
        self._scan = scan_batch_overlay
        self.gamma = gamma
        self.auto_compact = auto_compact
        self.async_compact = async_compact
        self.swaps = 0
        self.failed_swaps = 0
        self._inflight = None
        self.shard = IndexShard.wrap(idx, gamma, device=self.device)
        # device-resident write path (DESIGN.md §14): per-step writes merge
        # into the device pack as O(batch) deltas; False keeps the old
        # full-repack path (the write-path benchmark baseline)
        self.overlay_merge = bool(overlay_merge)
        self.shard.ov_merge = self.overlay_merge

    # ------------------------------------------- shard-state delegation
    @property
    def idx(self) -> Aulid:
        return self.shard.idx

    @property
    def overlay(self) -> DeltaOverlay:
        return self.shard.overlay

    @property
    def di(self) -> DeviceIndex:
        return self.shard.di

    @property
    def arrs(self) -> dict:
        return self.shard.arrs

    @property
    def ov_arrs(self) -> dict:
        return self.shard.ov_arrs

    @property
    def compactions(self) -> int:
        return self.shard.compactions

    # ------------------------------------------------------------ write path
    def _apply_write(self, req: IndexRequest) -> None:
        req.result = self.shard.apply_write(req.op, req.key, req.payload)
        req.done = True
        self.writes_applied += 1

    def compact(self) -> None:
        self.drain_compactions()
        self.shard.compact()

    def _maybe_compact(self) -> bool:
        if not (self.auto_compact and self.shard.needs_compaction(self.gamma)):
            return False
        if not self.async_compact:
            self.shard.compact()
            return True
        if self._inflight is None:     # one build in flight per engine
            self.shard.freeze()
            self._inflight = compaction_executor().submit(self._build_job)
        return False   # reads still need the merged frozen+live pack

    def _build_job(self):
        """Background build+upload (DESIGN.md §11): refresh the host mirror
        from the (frozen) index and prepare the full device pack off the
        request path.  Only reads foreground state the in-flight window
        freezes (``idx``, ``di``, ``arrs``).  The upload blocks until the
        device holds every pool, so a swap never installs half-copied
        pools."""
        shard = self.shard
        old = shard.di
        di = refresh_device_index(shard.idx, old)
        if di is old and shard.arrs is not None:
            arrs = update_leaf_rows(shard.arrs, di)
        else:
            arrs = device_arrays(di, self.device)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return di, arrs

    def _install_ready(self, block: bool) -> None:
        fut = self._inflight
        if fut is None or (not block and not fut.done()):
            return
        self._inflight = None
        try:
            di, arrs = fut.result()
        except Exception:
            # failed build: old mirror stays live, pending replays, frozen
            # overlay folds back under live (DESIGN.md §12) — no lost writes
            self.shard.abort_swap()
            self.shard.refresh_overlay_arrays()
            self.failed_swaps += 1
            return
        self.shard.finish_swap(di)
        self.shard.arrs = arrs
        self.shard.refresh_overlay_arrays()   # frozen retired: live-only pack
        self.swaps += 1

    def _begin_step(self) -> None:
        self._install_ready(block=False)

    def drain_compactions(self) -> None:
        """Block until any in-flight background compaction is installed."""
        self._install_ready(block=True)

    def _after_writes(self) -> None:
        # compact() already rebuilds the overlay device pack (for the now-
        # empty overlay); refresh it only when this step did not compact
        if not self._maybe_compact():
            self.shard.refresh_overlay_arrays()

    # ------------------------------------------------------------- read path
    def _snap(self) -> dict:
        return self.shard.arrs

    def _ov(self) -> dict:
        return self.shard.ov_arrs

    def _height(self) -> int:
        return max(self.di.max_inner_height, 3)

    def _overlay_live(self) -> int:
        return self.shard.overlay_live()

    # --------------------------------------------------------------- tracing
    def start_trace(self) -> Tracer:
        tr = super().start_trace()
        self.shard.tracer = tr
        return tr

    def stop_trace(self) -> Tracer:
        self.shard.tracer = None
        return super().stop_trace()

    def _indexes(self) -> list:
        return [self.shard.idx]

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        return {
            **super().stats(),
            "read_backend": self.read_backend,
            "overlay_len": len(self.overlay),
            "compactions": self.compactions,
            "swaps": self.swaps,
            "failed_swaps": self.failed_swaps,
            "inflight": int(self._inflight is not None),
            "mirror_refreshes": self.di.refreshes,
            "mirror_full_builds": self.di.full_builds,
            "overlay_merges": self.shard.overlay_merges,
            "overlay_reseeds": self.shard.overlay_reseeds,
            "write_h2d_bytes": self.shard.write_h2d_bytes,
        }
