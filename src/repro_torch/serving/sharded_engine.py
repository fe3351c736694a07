"""Shard-parallel serving engine over a range-partitioned AULID — the port
of ``src/repro/serving/sharded_engine.py`` (DESIGN.md §9, §11, §12, §14)
onto one CUDA device.

The monolithic :class:`~repro_torch.serving.index_engine.IndexEngine` serves
every request through ONE host index and ONE device mirror, so every
compaction stalls the whole key space behind an O(n) mirror rebuild.  This
engine partitions the key space into range shards (``core/partition.py``)
and keeps one :class:`IndexShard` per range:

* **writes** route to their shard's host index + overlay with one
  ``searchsorted`` over the boundary table;
* **compaction** is *shard-local*: a hot shard folding its overlay refreshes
  only its own mirror and re-uploads only its own slice of the stacked pools
  (``restack_shard`` + ``update_stacked_shard``) — cold shards' mirrors keep
  their snapshot epoch;
* **reads** execute as ONE device batch per step: the stacked ``(S, …)``
  mirror pools feed K1's shard route (``lookup_batch_sharded_overlay``) and
  the cross-shard scan (``scan_batch_sharded_overlay``, shard-successor leaf
  chain), with all shard overlays concatenated into one globally sorted pack
  (shards partition the key space in order, so concatenation in shard order
  IS the sort); the step's writes merge into that pack through K2.

Request semantics equal the monolithic engine's, request for request, and
are the same whether compactions run synchronously or double-buffered
(DESIGN.md §11): with ``async_compact=True`` (the default) a shard crossing
its gamma threshold freezes its overlay, builds + uploads its refreshed
mirror slice on a background thread, and installs it at a later step
boundary while reads keep serving the old epoch merged with the frozen
overlay.  ``repartition=True`` adds online split/merge under drift
(DESIGN.md §12) through the same freeze → background build → swap path,
over a versioned boundary table.

``mesh=`` places the stacked pools on a 1-D index mesh (DESIGN.md §13,
``repro_torch.parallel.index_mesh``): each position holds only its own
shards' pool slices, a read launches K1's shard route once for each
position over its own shards and merges the overlay on the mesh's first
device (K3), and shard installs, the background compaction and
repartition swaps included, write into the position that holds the shard.
Shard slots pad to a device multiple so the leading axis always divides
the mesh; request semantics are unchanged.  A mesh may name one card more
than once (``index_mesh``): that exercises the routing, the per-position
launches and the installs, not copies between cards.

The host logic is the reference's, line for line: the engine runs on
``cuda:0`` unless built with ``device="cpu"`` (with a mesh: on the mesh's
first device), where K1's and K2's plain versions serve
(``stats()["read_backend"]``: ``"cuda"`` or ``"torch"``).  Stacked pool
installs write in place (``core.lookup.update_stacked_shard``), between
steps only.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.delta_overlay import (DeltaOverlay, UINT64_MAX, merge_overlays,
                                  next_pow2)
from ..core.device_index import (build_device_index, install_shard_slices,
                                 pad_shard_slices, rechain_stacked,
                                 refresh_device_index, restack_shard,
                                 stack_device_indexes, stacked_pool_caps)
from ..core.keys import keys_to_tensor
from ..core.lookup import (lookup_batch_sharded_overlay,
                           lookup_batch_sharded_overlay_mesh,
                           merge_overlay_pack, overlay_from_numpy,
                           scan_batch_sharded_overlay,
                           scan_batch_sharded_overlay_mesh,
                           stacked_device_arrays, update_stacked_shard,
                           update_stacked_shard_mesh, upload_shard_slices)
from ..core.partition import RangePartition
from ..device import resolve
from ..parallel.index_placement import (mesh_num_devices, place_overlay_pack,
                                        place_stacked)
from .index_engine import (BaseIndexEngine, IndexRequest, IndexShard,
                           compaction_executor, pad_queries)


class ShardedIndexEngine(BaseIndexEngine):
    """Batching engine for mixed get/insert/delete/scan over range shards.

    ``device`` defaults to ``cuda:0`` and raises without CUDA; pass
    ``device="cpu"`` for the plain PyTorch path.  With ``mesh`` (from
    ``parallel.index_mesh``) the engine runs on the mesh's first device,
    and a ``device`` naming another raises."""

    def __init__(self, part: RangePartition, *, device=None,
                 gamma: float = 0.05, auto_compact: bool = True,
                 async_compact: bool = True, repartition: bool = False,
                 split_ratio: float = 4.0, min_split_items: int = 128,
                 repartition_check_every: int = 1, mesh=None,
                 overlay_merge: bool = True):
        if mesh is not None:
            if device is not None and resolve(device) != mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {mesh.devices[0]}")
            device = mesh.devices[0]
        super().__init__(device)
        # the tensors' device picks the path: K1's shard route and K2 on
        # cuda, their plain versions on cpu; scans walk in plain PyTorch
        self.read_backend = "cuda" if self.device.type == "cuda" else "torch"
        self.mesh = mesh
        if mesh is None:
            self._lookup = lookup_batch_sharded_overlay
            self._scan = scan_batch_sharded_overlay
        else:
            # mesh placement (DESIGN.md §13): reads and installs go through
            # the per-position twins, and every stack build places its pools
            self._lookup = self._mesh_lookup_entry
            self._scan = self._mesh_scan_entry
        self._route_q = None          # the host keys of the batch in flight
        self.part = part
        self.gamma = gamma
        self.auto_compact = auto_compact
        self.async_compact = async_compact
        # online repartitioning policy (DESIGN.md §12)
        self.repartition = repartition
        self.split_ratio = float(split_ratio)
        self.min_split_items = int(min_split_items)
        self.repartition_check_every = max(1, int(repartition_check_every))
        self.splits = 0
        self.merges = 0
        self.failed_swaps = 0        # compaction builds that raised
        self.repart_failures = 0     # split/merge builds that raised
        self._repart_inflight = None  # (kind, shard, pinned version, Future)
        self._step_version = None     # boundary version pinned by this step
        self._min_slots = 0           # shard-slot capacity ratchet
        self._write_counts = [0] * part.num_shards  # inserts since sample
        self.shards = [IndexShard.wrap(idx, gamma, with_arrays=False,
                                       device=self.device)
                       for idx in part.shards]
        self.sdi = stack_device_indexes(
            [sh.di for sh in self.shards], part.bounds,
            min_shards=self._shard_slots(len(self.shards)))
        self.stk = self._stacked_arrays(self.sdi, part.version)
        # merged-pack capacity floor ~= sum of shard thresholds: one pack
        # shape across the shards' whole lifetime
        self._ov_floor = next_pow2(
            max(int(gamma * max(part.n_items, 1)), 64))
        # merged-pack rebuild memo: per-shard segment cache + whole-pack
        # signature, both keyed by the overlays' never-recycled (uid, version)
        # pairs — steps whose writes changed nothing skip the O(total) rebuild
        self._seg_cache: dict[int, tuple] = {}
        self._pack_sig: tuple | None = None
        self._pack_live = 0
        self.pack_skips = 0
        # device-resident write path (DESIGN.md §14): while every shard's
        # (live uid, frozen uid) structure is unchanged, per-step writes ship
        # as ONE concatenated sorted batch (shard ranges are disjoint and
        # ordered, so shard-order concatenation is globally sorted) and merge
        # into the pack on device (K2); False keeps the full-rebuild path
        self.overlay_merge = bool(overlay_merge)
        self._pack_struct: tuple | None = None
        self.write_h2d_bytes = 0
        self.overlay_merges = 0
        self.overlay_reseeds = 0
        self.ov_arrs = None
        self.ov_arrs = self._merged_overlay_pack()
        self.restacks = 0                     # full re-stacks (shard outgrew pad)
        self.swaps = 0                        # double-buffered epoch swaps
        self._inflight: dict[int, object] = {}   # shard id -> build Future

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def compactions(self) -> int:
        return sum(sh.compactions for sh in self.shards)

    # ------------------------------------------------------------ write path
    def _apply_write(self, req: IndexRequest) -> None:
        s = self.part.shard_of(req.key)
        sh = self.shards[s]
        req.result = sh.apply_write(req.op, req.key, req.payload)
        req.done = True
        self.writes_applied += 1
        if req.op == "insert":
            self._write_counts[s] += 1   # load-monitor insert-rate window

    def _after_writes(self) -> None:
        if self.auto_compact:
            self._maybe_compact()
        self.ov_arrs = self._merged_overlay_pack()

    def _maybe_compact(self) -> None:
        """Shard-local compaction: only shards past their own gamma threshold
        fold their overlay.  Synchronous mode re-uploads their mirror slices
        inline; double-buffered mode (default) freezes each shard's overlay
        and hands the build+upload to a background thread (DESIGN.md §11) —
        one build in flight per shard."""
        if self._repart_inflight is not None:
            # a repartition owns the maintenance window: shard ids shift at
            # its install, so no compaction may start (or restack) under it —
            # overlays keep absorbing writes and compact after the install
            return
        changed = [s for s, sh in enumerate(self.shards)
                   if sh.needs_compaction(self.gamma)
                   and s not in self._inflight]
        if not changed:
            return
        if not self.async_compact:
            for s in changed:
                self.shards[s].compact()
            self._refresh_stack(changed)
            return
        for s in changed:
            self.shards[s].freeze()
            self._inflight[s] = compaction_executor().submit(
                self._build_job, s, self.sdi)

    def _synchronize(self) -> None:
        """Block until the devices hold what this thread enqueued, so a
        background build never hands over half-copied tensors."""
        devices = [self.device] if self.mesh is None \
            else self.mesh.distinct_devices()
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()

    def _stacked_arrays(self, sdi, version: int = 0) -> dict:
        """The device stack of ``sdi``; with a mesh, built on the host and
        placed (``place_stacked``: each position's slice moved once to its
        device), beside the host copy of its boundary table that
        ``_mesh_qcap`` routes on."""
        if self.mesh is None:
            return stacked_device_arrays(sdi, version, self.device)
        stk = place_stacked(stacked_device_arrays(sdi, version, "cpu"),
                            self.mesh)
        stk["route_bounds"] = np.array(sdi.bounds, dtype=np.uint64)
        return stk

    def _update_stack(self, changed: list[int],
                      dev_slices: dict | None = None) -> None:
        if self.mesh is None:
            self.stk = update_stacked_shard(self.stk, self.sdi, changed,
                                            dev_slices=dev_slices)
        else:
            self.stk = update_stacked_shard_mesh(self.mesh, self.stk,
                                                 self.sdi, changed,
                                                 dev_slices=dev_slices)

    def _build_job(self, s: int, sdi):
        """Background build+upload for shard ``s`` (freeze -> build -> upload
        of the lifecycle): refresh the shard mirror, pad it to the stacked
        slice shapes, and push the slices to the device — all off the
        request path.  Only reads state the in-flight window freezes (the
        shard's host index and mirror); ``sdi`` is captured at submit so a
        concurrent full re-stack is detected at install time."""
        sh = self.shards[s]
        di = refresh_device_index(sh.idx, sh.di)
        slices = pad_shard_slices(sdi, di)
        dev = None
        if slices is not None:
            dev = upload_shard_slices(slices, self.device)
            self._synchronize()
        return s, di, sdi, slices, dev

    def _install_ready(self, block: bool) -> None:
        """Swap stage (DESIGN.md §11), run between request batches: install
        every finished background build — retire its frozen overlay, replay
        deferred host writes, copy the pre-uploaded device slices into the
        stacked pools — and rechain once.  A build whose slices no longer fit
        the current stack (concurrent full re-stack, or the shard outgrew its
        pad) falls back to the synchronous re-stack path.  A build that
        RAISED rolls its shard back via ``abort_swap`` (old epoch stays live,
        pending log replays — no lost writes, DESIGN.md §12).  Finished
        split/merge builds install last (``_install_repart``)."""
        touched = False
        if self._inflight:
            ready = []
            for s in list(self._inflight):
                fut = self._inflight[s]
                if block or fut.done():
                    del self._inflight[s]
                    try:
                        ready.append(fut.result())
                    except Exception:
                        self.shards[s].abort_swap()
                        self.failed_swaps += 1
                        touched = True
            if ready:
                changed, dev_slices, need_full = [], {}, False
                for s, di, sdi_ref, slices, dev in ready:
                    self.shards[s].finish_swap(di)
                    changed.append(s)
                    if (sdi_ref is self.sdi and slices is not None
                            and all(dev[f].shape
                                    == getattr(self.sdi, f).shape[1:]
                                    for f in dev)):
                        install_shard_slices(self.sdi, s, di, slices)
                        dev_slices[s] = dev
                    else:
                        self.sdi.dis[s] = di
                        if not restack_shard(self.sdi, s, rechain=False):
                            need_full = True
                self.swaps += len(changed)
                if need_full:
                    self._full_restack()
                else:
                    rechain_stacked(self.sdi)   # once, after all installs
                    self._update_stack(changed, dev_slices)
                touched = True
        if self._repart_inflight is not None:
            fut = self._repart_inflight[-1]
            if block or fut.done():
                self._install_repart()
                touched = True
        if touched:
            # frozen overlays retired / shard layout changed -> rebuild pack
            self.ov_arrs = self._merged_overlay_pack()

    def _begin_step(self) -> None:
        self._install_ready(block=False)
        if self.repartition and self.steps % self.repartition_check_every == 0:
            self._maybe_repartition()
        # pin the boundary-table version this step routes and scans on
        # (DESIGN.md §12); released in _end_step once the last batch served
        self._step_version = self.part.pin()

    def _end_step(self) -> None:
        if self._step_version is not None:
            self.part.unpin(self._step_version)
            self._step_version = None

    def drain_compactions(self) -> None:
        """Block until every in-flight background build (compaction or
        split/merge) is installed."""
        self._install_ready(block=True)

    def _full_restack(self) -> None:
        self.sdi = stack_device_indexes(
            [sh.di for sh in self.shards], self.part.bounds,
            min_shards=self._shard_slots(len(self.shards)),
            min_caps=self._pool_caps())
        self.stk = self._stacked_arrays(self.sdi, self.part.version)
        self.restacks += 1

    def _pool_caps(self):
        """Pool-capacity ratchet floor for rebuilt stacks (DESIGN.md §12):
        with repartitioning on, a split/merge install (or restack) never
        SHRINKS a pool shape.  None (exact fit) otherwise, preserving the
        frozen-partition engine's layout bit for bit."""
        return stacked_pool_caps(self.sdi) if self.repartition else None

    def _refresh_stack(self, changed: list[int]) -> None:
        for s in changed:
            self.sdi.dis[s] = self.shards[s].di
        fits = [restack_shard(self.sdi, s, rechain=False) for s in changed]
        if all(fits):
            rechain_stacked(self.sdi)   # once, after all re-pads
            self._update_stack(changed)
        else:   # a shard outgrew its padded pool capacity: re-stack all
            self._full_restack()

    # --------------------------------------------------- online repartitioning
    def _shard_slots(self, n: int) -> int:
        """Padded shard-slot capacity for ``n`` live shards: pow2 above 25%
        headroom, ratcheted so it never shrinks — splits/merges within
        capacity change no stacked shape (DESIGN.md §12).  0 (exact fit)
        when repartitioning is off, preserving the frozen-partition engine's
        layout bit for bit.  Placeholder slots carry UINT64_MAX bounds, so
        routing never sends a real query to one.

        With a mesh, slots also round up to a device multiple so the
        stacked leading axis always divides the mesh (DESIGN.md §13); the
        placeholders lie on the last positions."""
        D = self._mesh_devices()
        if not self.repartition and D <= 1:
            return 0
        base = next_pow2(n + max(n // 4, 1)) if self.repartition else n
        if D > 1:
            base = -(-base // D) * D
        self._min_slots = max(self._min_slots, base)
        return self._min_slots

    def _mesh_devices(self) -> int:
        return mesh_num_devices(self.mesh)

    def _maybe_repartition(self) -> None:
        """Load monitor + trigger policy, sampled in ``_begin_step``
        (DESIGN.md §12): when the max/min shard-size ratio crosses
        ``split_ratio``, split the oversized shard at its median key if IT is
        the outlier from the mean (sustained drift feeding one shard), else
        merge the undersized shard into its smaller neighbor (a drained
        range).  The insert-rate window breaks size ties toward the shard
        the drift is feeding.  One repartition in flight at a time, and
        never concurrently with compaction builds (shard ids shift)."""
        if self._repart_inflight is not None or self._inflight:
            return
        sizes = [sh.idx.n_items for sh in self.shards]
        rates, self._write_counts = self._write_counts, [0] * len(sizes)
        mx, mn = max(sizes), min(sizes)
        if mx <= self.split_ratio * max(mn, 1):
            return
        mean = sum(sizes) / len(sizes)
        if mx / max(mean, 1.0) >= mean / max(mn, 1):
            s = max(range(len(sizes)), key=lambda i: (sizes[i], rates[i]))
            if sizes[s] >= 2 * self.min_split_items:
                self.request_split(s)
        elif len(self.shards) > 1:
            s = min(range(len(sizes)), key=lambda i: (sizes[i], -rates[i]))
            if s == len(sizes) - 1 or (s > 0 and sizes[s - 1] < sizes[s + 1]):
                s -= 1               # merge with the smaller neighbor
            self.request_merge(s)

    def request_split(self, s: int, split_key: int | None = None) -> bool:
        """Begin an online split of shard ``s`` (public for tests and forced
        repartitions).  Async mode freezes the shard and builds the
        post-split stacked mirror on a background thread; sync mode rebuilds
        inline.  Returns False when it cannot start (a repartition or
        compaction already in flight, or no valid split key)."""
        if self._repart_inflight is not None or self._inflight:
            return False
        if self.shards[s].frozen_overlay is not None:
            return False
        if split_key is None:
            split_key = self.part.plan_split(s)
        if split_key is None:
            return False
        if not self.async_compact:
            self._split_sync(s, int(split_key))
            return True
        self.shards[s].freeze(count=False)
        ver = self.part.pin()
        fut = compaction_executor().submit(
            self._split_job, s, int(split_key), self.sdi, self.sdi.epoch)
        self._repart_inflight = ("split", s, ver, fut)
        return True

    def request_merge(self, s: int) -> bool:
        """Begin an online merge of shards ``s`` and ``s+1`` (the symmetric
        case of :meth:`request_split`)."""
        if self._repart_inflight is not None or self._inflight:
            return False
        if not 0 <= s < len(self.shards) - 1:
            return False
        if (self.shards[s].frozen_overlay is not None
                or self.shards[s + 1].frozen_overlay is not None):
            return False
        if not self.async_compact:
            self._merge_sync(s)
            return True
        self.shards[s].freeze(count=False)
        self.shards[s + 1].freeze(count=False)
        ver = self.part.pin()
        fut = compaction_executor().submit(self._merge_job, s, self.sdi,
                                           self.sdi.epoch)
        self._repart_inflight = ("merge", s, ver, fut)
        return True

    def _new_shard(self, idx, di=None) -> IndexShard:
        overlay = DeltaOverlay.for_threshold(
            self.gamma * max(idx.n_items, 1))
        return IndexShard(idx=idx, overlay=overlay,
                          di=build_device_index(idx) if di is None else di,
                          device=self.device)

    def _build_split(self, s: int, split_key: int):
        """Bulkload both halves of shard ``s`` from its (frozen) host items:
        left takes keys <= split_key."""
        keys, pays = self.part.shard_items(s)
        cut = int(np.searchsorted(keys, np.uint64(split_key), side="right"))
        left = self.part.spawn_index()
        left.bulkload(keys[:cut], pays[:cut])
        right = self.part.spawn_index()
        right.bulkload(keys[cut:], pays[cut:])
        return left, right

    def _build_merged(self, s: int):
        """Bulkload shards ``s`` and ``s+1``'s (frozen) host items into one
        index — ranges are adjacent and ordered, so concatenation is sorted."""
        ka, pa = self.part.shard_items(s)
        kb, pb = self.part.shard_items(s + 1)
        merged = self.part.spawn_index()
        merged.bulkload(np.concatenate([ka, kb]), np.concatenate([pa, pb]))
        return merged

    def _restack_job(self, new_dis: list, new_bounds: np.ndarray):
        """The ENTIRE post-repartition padded stack and its device pools,
        built off the request path (the upload is complete on return)."""
        new_sdi = stack_device_indexes(
            new_dis, new_bounds, min_shards=self._shard_slots(len(new_dis)),
            min_caps=self._pool_caps())
        new_stk = self._stacked_arrays(new_sdi)
        self._synchronize()
        return new_sdi, new_stk

    def _split_job(self, s: int, split_key: int, sdi, epoch: int):
        """Background build of a split (DESIGN.md §12): the two half indexes,
        their mirrors, and the whole post-split stack + device pools.  Reads
        only state the freeze window keeps immutable (shard ``s``'s host
        index; cold mirrors — compaction is paused while a repartition is in
        flight, asserted at install via the captured ``sdi``/``epoch``)."""
        left, right = self._build_split(s, split_key)
        new_dis = [sh.di for sh in self.shards]
        new_dis[s:s + 1] = [build_device_index(left),
                            build_device_index(right)]
        new_sdi, new_stk = self._restack_job(
            new_dis, np.insert(self.part.bounds, s, np.uint64(split_key)))
        return s, split_key, left, right, new_sdi, new_stk, sdi, epoch

    def _merge_job(self, s: int, sdi, epoch: int):
        """Background build of a merge (the symmetric case of
        :meth:`_split_job`)."""
        merged = self._build_merged(s)
        new_dis = [sh.di for sh in self.shards]
        new_dis[s:s + 2] = [build_device_index(merged)]
        new_sdi, new_stk = self._restack_job(
            new_dis, np.delete(self.part.bounds, s))
        return s, merged, new_sdi, new_stk, sdi, epoch

    def _route_window_writes(self, old: IndexShard, targets) -> None:
        """Carry a frozen shard's in-flight-window writes into its
        replacement shards: live-overlay entries re-record into the target
        overlays (the new mirrors were built BEFORE these writes, so reads
        must keep seeing them overlay-first), and the pending log replays
        into the new host indexes in arrival order — the exactness argument
        for writes that straddle a split (DESIGN.md §12).  ``targets`` maps
        a key to its replacement (IndexShard, host index) pair."""
        for k, pay, tomb in old.overlay.range_items(0):
            tsh, _ = targets(k)
            if tomb:
                tsh.overlay.record_delete(k)
            else:
                tsh.overlay.record_insert(k, pay)
        for op, key, payload in old.pending:
            _, tidx = targets(key)
            if op == "insert":
                if not tidx.update(key, payload):
                    tidx.insert(key, payload)
            else:
                tidx.delete(key)

    def _install_repart(self) -> None:
        """Install a finished split/merge build between request batches
        (DESIGN.md §12): adopt the pre-built stacked mirror + device pools
        wholesale, route the frozen shards' window writes into the new
        shards, bump the boundary-table version, and release the build's
        pin.  A build that RAISED leaves the old version live — the frozen
        windows roll back via ``abort_swap`` with the pending log intact."""
        kind, s, ver, fut = self._repart_inflight
        self._repart_inflight = None
        try:
            result = fut.result()
        except Exception:
            self.shards[s].abort_swap()
            if kind == "merge":
                self.shards[s + 1].abort_swap()
            self.part.unpin(ver)
            self.repart_failures += 1
            return
        if kind == "split":
            s, split_key, left, right, new_sdi, new_stk, sdi_ref, epoch = \
                result
            assert sdi_ref is self.sdi and epoch == self.sdi.epoch, \
                "stacked pools changed during a repartition flight"
            old = self.shards[s]
            lsh = self._new_shard(left, di=new_sdi.dis[s])
            rsh = self._new_shard(right, di=new_sdi.dis[s + 1])
            self._route_window_writes(
                old, lambda k: (lsh, left) if k <= split_key else (rsh, right))
            self.part.apply_split(s, split_key, left, right)
            self.shards[s:s + 1] = [lsh, rsh]
            self.splits += 1
        else:
            s, merged, new_sdi, new_stk, sdi_ref, epoch = result
            assert sdi_ref is self.sdi and epoch == self.sdi.epoch, \
                "stacked pools changed during a repartition flight"
            msh = self._new_shard(merged, di=new_sdi.dis[s])
            for old in (self.shards[s], self.shards[s + 1]):
                self._route_window_writes(old, lambda k: (msh, merged))
            self.part.apply_merge(s, merged)
            self.shards[s:s + 2] = [msh]
            self.merges += 1
        self.part.unpin(ver)
        self.sdi = new_sdi
        new_stk["bounds_version"] = self.part.version
        self.stk = new_stk
        # shard ids shifted: reset the per-index caches/windows
        self._write_counts = [0] * len(self.shards)
        self._seg_cache.clear()
        self._pack_sig = None
        self._pack_struct = None    # shard list changed: next pack reseeds

    def _split_sync(self, s: int, split_key: int) -> None:
        """Inline split (sync mode): overlays are already folded into the
        host indexes (sync writes apply to both), so the rebuilt halves
        absorb them and the replacement shards start with empty overlays —
        request-for-request equivalent to the async path (DESIGN.md §12)."""
        left, right = self._build_split(s, split_key)
        self.part.apply_split(s, split_key, left, right)
        self.shards[s:s + 1] = [self._new_shard(left), self._new_shard(right)]
        self.splits += 1
        self._after_repartition_sync()

    def _merge_sync(self, s: int) -> None:
        merged = self._build_merged(s)
        self.part.apply_merge(s, merged)
        self.shards[s:s + 2] = [self._new_shard(merged)]
        self.merges += 1
        self._after_repartition_sync()

    def _after_repartition_sync(self) -> None:
        self._write_counts = [0] * len(self.shards)
        self._seg_cache.clear()
        self._pack_sig = None
        self._pack_struct = None
        self._full_restack()
        self.ov_arrs = self._merged_overlay_pack()

    # ----------------------------------------------------------- overlay pack
    def _overlay_sig(self) -> tuple:
        """Per-shard (live uid, live version, frozen uid, frozen version)
        signature of the served overlay state — uids are never recycled
        (``delta_overlay`` module doc), so signature equality is exactly
        served-view equality."""
        return tuple((sh.overlay.uid, sh.overlay.version,
                      sh.frozen_overlay.uid if sh.frozen_overlay else 0,
                      sh.frozen_overlay.version if sh.frozen_overlay else 0)
                     for sh in self.shards)

    def _merged_overlay_pack(self) -> dict:
        """Concatenate the shards' sorted overlays (frozen merged under live
        while a compaction is in flight) into one globally sorted padded pack
        (``overlay_arrays`` layout): shard key ranges are disjoint and
        ordered, so shard order IS global key order.

        Rebuilds are memoised on the overlay signature: untouched shards
        reuse their cached merged segment, and a step that changed nothing
        reuses the whole pack.

        Delta path (DESIGN.md §14): while every shard's (live uid, frozen
        uid) structure matches what the current pack was seeded against,
        only versions have advanced — i.e. plain writes — so the pack
        absorbs the shards' drained pending batches as ONE device merge (K2)
        of O(batch) uploaded bytes instead of this full O(total) rebuild.
        Any uid change (freeze, swap, clear, repartition) falls through to
        the rebuild, which re-seeds the pack from host state (uploaded into
        the spare of ``merge_overlay_pack``'s two packs) and marks every
        overlay synced."""
        sig = self._overlay_sig()
        if sig == self._pack_sig and self.ov_arrs is not None:
            self.pack_skips += 1
            return self.ov_arrs
        struct = tuple((s[0], s[2]) for s in sig)
        if (self.overlay_merge and self.ov_arrs is not None
                and struct == self._pack_struct):
            out = self._delta_merge_pack(sig)
            if out is not None:
                return out
        segs = []
        total = 0
        for s, (sh, ssig) in enumerate(zip(self.shards, sig)):
            ent = self._seg_cache.get(s)
            if ent is None or ent[0] != ssig:
                ent = (ssig, merge_overlays(sh.frozen_overlay, sh.overlay))
                self._seg_cache[s] = ent
            segs.append(ent[1])
            total += ent[1][0].shape[0]
        cap = max(self._ov_floor, next_pow2(total))
        pack = np.empty((3, cap), dtype=np.uint64)
        pack[0] = UINT64_MAX
        pack[1] = 0
        pack[2] = 0
        off = 0
        for keys, pays, tomb in segs:
            n = keys.shape[0]
            if n:
                pack[0, off:off + n] = keys
                pack[1, off:off + n] = pays
                pack[2, off:off + n] = tomb
                off += n
        self._pack_sig = sig
        self._pack_live = total
        # reseed boundary: the pack now reflects full host state, so the
        # shards' pending deltas are moot and the structure token advances
        for sh in self.shards:
            sh.overlay.mark_synced()
            if sh.frozen_overlay is not None:
                sh.frozen_overlay.mark_synced()
        self._pack_struct = struct
        self.overlay_reseeds += 1
        self.write_h2d_bytes += int(pack.nbytes)
        ovr = overlay_from_numpy(pack, self.device, fill=total,
                                 prev=self.ov_arrs)
        if self.mesh is not None:
            # replicated once, here: later delta merges run on every copy
            ovr = place_overlay_pack(ovr, self.mesh)
        return ovr

    def _delta_merge_pack(self, sig: tuple) -> dict | None:
        """O(batch) write-path sync: drain every shard's pending writes, ship
        the one concatenated sorted batch, merge on device.  Returns None
        when there is nothing to merge (a version bump without pending
        writes — e.g. an external ``arrays()`` drain), falling back to the
        full rebuild."""
        batches = [sh.overlay.take_batch() for sh in self.shards]
        bk = np.concatenate([b[0] for b in batches])
        if bk.size == 0:
            return None
        bp = np.concatenate([b[1] for b in batches])
        bt = np.concatenate([b[2] for b in batches])
        # upper bound on merged pack fill (scan ov_bound); exact counts live
        # in the host dicts, so cap growth is known without a device sync
        bound = sum(sh.overlay_live() for sh in self.shards)
        cap_out = max(int(self.ov_arrs["ov_pack"].shape[1]),
                      self._ov_floor, next_pow2(bound))
        ovr, nbytes = merge_overlay_pack(self.ov_arrs, (bk, bp, bt), cap_out,
                                         bound)
        if self.mesh is not None:
            # one merge for each other distinct device's copy (none on a
            # mesh of one card), then the placed dict is assembled anew
            ovr["ov_replicas"] = tuple(
                merge_overlay_pack(r, (bk, bp, bt), cap_out, bound)[0]
                for r in self.ov_arrs["ov_replicas"])
        self._pack_sig = sig
        self._pack_live = bound
        self.write_h2d_bytes += nbytes
        self.overlay_merges += 1
        return ovr

    # ------------------------------------------------------------- read path
    # With a mesh, a tight qcap is the point: each position's K1 window is
    # Sl * qcap queries, so the pow2-bucketed routing bound below turns
    # shard locality into less work a position.  The route is taken on the
    # host keys of the batch (kept by ``_queries``), so it costs no device
    # sync.  The reference's ``_mesh_route`` also builds the lane matrix of
    # its host-routed jnp path, which the port does not have.
    def _queries(self, keys: list[int]) -> torch.Tensor:
        self._route_q = pad_queries(keys)
        return keys_to_tensor(self._route_q, self.device)

    def _mesh_qcap(self, snap: dict) -> int:
        """Pow2-bucketed per-shard routing bound of the batch in flight,
        routed on the SNAPSHOT's boundary table (during an in-flight
        repartition the pinned snapshot may trail ``self.sdi``; routing and
        traversal must agree)."""
        qn = self._route_q
        real = qn != UINT64_MAX
        if not real.any():
            return min(8, qn.shape[0])
        bounds = snap["route_bounds"]
        sid = np.searchsorted(bounds, qn[real], side="left")
        mx = int(np.bincount(sid, minlength=bounds.shape[0] + 1).max())
        return min(next_pow2(max(mx, 8)), qn.shape[0])

    def _mesh_lookup_entry(self, snap, ovr, q, height: int = 3):
        return lookup_batch_sharded_overlay_mesh(
            self.mesh, snap, ovr, q, height=height,
            qcap=self._mesh_qcap(snap))

    def _mesh_scan_entry(self, snap, ovr, q, count: int = 100,
                         height: int = 3, ov_bound=None):
        return scan_batch_sharded_overlay_mesh(
            self.mesh, snap, ovr, q, count=count, height=height,
            ov_bound=ov_bound, qcap=self._mesh_qcap(snap))

    def _snap(self) -> dict:
        return self.stk

    def _ov(self) -> dict:
        return self.ov_arrs

    def _height(self) -> int:
        return max(self.sdi.max_inner_height, 3)

    def _indexes(self) -> list:
        return [sh.idx for sh in self.shards]

    def _overlay_live(self) -> int:
        # tracked pack occupancy: on rebuild the recorded fill IS the served
        # frozen+live entry count; on a delta merge it is the host dicts'
        # upper bound on it (always >= the pack's true fill — safe ov_bound)
        return self._pack_live

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        return {
            **super().stats(),
            "read_backend": self.read_backend,
            "mesh_devices": self._mesh_devices(),
            "num_shards": self.num_shards,
            "overlay_len": sum(sh.overlay_live() for sh in self.shards),
            "compactions": self.compactions,
            "compactions_per_shard": [sh.compactions for sh in self.shards],
            "mirror_refreshes": sum(sh.di.refreshes for sh in self.shards),
            "mirror_full_builds": sum(sh.di.full_builds
                                      for sh in self.shards),
            "full_restacks": self.restacks,
            "swaps": self.swaps,
            "failed_swaps": self.failed_swaps,
            "inflight": len(self._inflight),
            "pack_skips": self.pack_skips,
            "overlay_merges": self.overlay_merges,
            "overlay_reseeds": self.overlay_reseeds,
            "write_h2d_bytes": self.write_h2d_bytes,
            "splits": self.splits,
            "merges": self.merges,
            "repart_failures": self.repart_failures,
            "repart_inflight": int(self._repart_inflight is not None),
            "boundary_version": self.part.version,
            "shard_sizes": [sh.idx.n_items for sh in self.shards],
        }
