"""Batched device read/write path over a :class:`DeviceIndex` mirror — the
port of ``src/repro/core/lookup.py``: the monolithic path (S=1), the
range-sharded one over a :class:`StackedDeviceIndex`, and its mesh twins.

The mirror lives on one device as the dict that :func:`mirror_from_numpy`
builds: the pools of ``_STACK_2D + _STACK_3D`` in the layout the K1 kernel
reads directly (``kernels.fused_lookup.ops.POOL_DTYPES``), u64 keys biased
to int64 and payloads as int64 bits (``core.keys``).  A stacked mirror
(:func:`stacked_device_arrays`) is the same dict with a leading shard axis
on every pool, plus the boundary table and the cross-shard leaf chain.
The overlay is one (3, cap) int64 pack: biased keys, payload bits,
tombstones 0/1.

The mesh twins (``*_mesh``) read a stacked mirror placed on an index mesh
(``parallel.place_stacked``): each position reads its own shards, and the
results sum, disjoint, on the mesh's first device.

Point reads and overlay merges dispatch by the tensors' device: on CUDA
they launch K1 (``fused_lookup``) and K2 (``overlay_merge``), on the CPU
they run those kernels' plain versions.  Scans have no kernel (the
reference runs them in jnp too): they are plain PyTorch on either device,
taking their start leaf from K1 on the card.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..device import resolve
from ..kernels.fused_lookup.ops import (KEY_FIELDS, POOL_DTYPES, STALE_STEPS,
                                        TAG_BT, TAG_DATA, TAG_MIXED, TAG_NULL,
                                        TAG_PA, fused_lookup,
                                        fused_lookup_sharded,
                                        fused_lookup_sharded_mesh)
from ..kernels.overlay_merge.ops import merge_overlay_pack_torch, overlay_merge
from ..kernels.overlay_probe.ops import overlay_probe
from ..parallel.index_placement import mesh_local_shards, place_stacked
from .delta_overlay import DeltaOverlay, UINT64_MAX, merge_overlays, next_pow2
from .device_index import (_STACK_2D, _STACK_3D, DeviceIndex,
                           StackedDeviceIndex)
from .keys import BIASED_MAX, bias_np

__all__ = ["STALE_STEPS", "TAG_NULL", "TAG_DATA", "TAG_PA", "TAG_BT",
           "TAG_MIXED", "device_arrays", "mirror_from_numpy",
           "overlay_from_numpy", "lookup_batch", "lookup_batch_overlay",
           "overlay_arrays", "overlay_arrays_merged",
           "merge_overlay_pack_torch", "empty_overlay_pack",
           "merge_overlay_pack", "update_leaf_rows", "scan_batch",
           "scan_batch_overlay", "stacked_device_arrays",
           "upload_shard_slices", "update_stacked_shard",
           "lookup_batch_sharded", "lookup_batch_sharded_overlay",
           "scan_batch_sharded", "scan_batch_sharded_overlay",
           "mesh_local_shards", "lookup_batch_sharded_mesh",
           "lookup_batch_sharded_overlay_mesh", "scan_batch_sharded_mesh",
           "scan_batch_sharded_overlay_mesh", "update_stacked_shard_mesh"]

# the mirror pools every read path gathers from (the reference's list)
_DEVICE_FIELDS = [f for f, _ in _STACK_2D + _STACK_3D]

# ------------------------------------------------------------ carrying state
_NP_DTYPES = {torch.int32: np.int32, torch.int64: np.int64,
              torch.float64: np.float64}


def _pool_tensor(name: str, a: np.ndarray, device) -> torch.Tensor:
    if name in KEY_FIELDS:
        a = bias_np(a)
    elif name == "leaf_pay":
        a = np.asarray(a, dtype=np.uint64).view(np.int64)
    else:
        a = np.asarray(a).astype(_NP_DTYPES[POOL_DTYPES[name]])
    # always a fresh array: the mirror never aliases the numpy pools, which
    # refresh_device_index mutates in place
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def mirror_from_numpy(pools: Mapping[str, np.ndarray], device) -> dict:
    """The port's device mirror of numpy mirror pools — the carry-over
    function: ``pools`` maps the ``DeviceIndex`` field names
    (``_STACK_2D + _STACK_3D`` plus ``root_node`` / ``last_leaf_row`` /
    ``last_leaf_min``) to arrays, whether from the reference package's
    ``DeviceIndex`` or from the port's copy."""
    dev = resolve(device)
    d = {f: _pool_tensor(f, pools[f], dev) for f in _DEVICE_FIELDS}
    d["meta"] = torch.tensor([int(pools["root_node"]),
                              int(pools["last_leaf_row"])],
                             dtype=torch.int32, device=dev)
    d["last_leaf_min"] = _pool_tensor(
        "slot_key", np.array([pools["last_leaf_min"]], dtype=np.uint64), dev)
    return d


def _di_pools(di: DeviceIndex) -> dict:
    pools = {f: getattr(di, f) for f in _DEVICE_FIELDS}
    pools.update(root_node=di.root_node, last_leaf_row=di.last_leaf_row,
                 last_leaf_min=di.last_leaf_min)
    return pools


def device_arrays(di: DeviceIndex, device=None) -> dict:
    """Move the mirror pools to ``device`` (default: the card)."""
    return mirror_from_numpy(_di_pools(di), device)


def overlay_from_numpy(pack, device=None, fill: int | None = None,
                       prev: dict | None = None) -> dict:
    """The port's overlay dict of a (3, cap) u64 overlay pack (keys,
    payloads, tombstones; ``UINT64_MAX`` key padding): ``ov_pack`` on
    ``device`` and ``ov_fill``, its live count (``fill``, counted from the
    pack when None).

    ``prev``, the overlay dict this one replaces (a reseed), lends its
    buffers (:func:`merge_overlay_pack`): the upload goes into its spare
    when the capacity matches, else the spare is dropped first, so no more
    than two packs are alive at once; its served pack becomes the new
    dict's spare when the capacity matches."""
    pack = np.asarray(pack, dtype=np.uint64)
    out = np.empty(pack.shape, dtype=np.int64)
    out[0] = bias_np(pack[0])
    out[1] = pack[1].view(np.int64)
    out[2] = pack[2] != 0
    if fill is None:
        fill = int(np.count_nonzero(pack[0] != UINT64_MAX))
    dev = resolve(device)
    host = torch.from_numpy(out)
    spare = _take_spare(prev, host.shape[1], dev)
    d = {"ov_pack": spare[0].copy_(host) if spare is not None
         else host.to(dev), "ov_fill": int(fill)}
    if prev is not None:
        _keep_spare(d, prev)
    return d


def _fill(ovr: dict) -> int:
    """The bound on ``ovr``'s live count past which its pack is padding
    (the whole pack for a dict that records none)."""
    return ovr.get("ov_fill", ovr["ov_pack"].shape[1])


def _take_spare(ovr: dict | None, cap: int, dev) -> tuple | None:
    """Pop ``ovr``'s spare, a (pack, fill bound) pair: returned when it is
    a (3, ``cap``) pack on ``dev``, else dropped (so a new pack can take
    its memory).  A spare is taken once: a second merge or reseed of the
    same dict allocates."""
    spare = ovr.pop("ov_spare", None) if ovr is not None else None
    if spare is None or spare[0].shape[1] != cap or spare[0].device != dev:
        return None
    return spare


def _keep_spare(d: dict, prev: dict) -> None:
    """Keep ``prev``'s pack (the one ``d`` replaces) as ``d``'s spare when
    it matches ``d``'s pack.  The spare rides the dict as a (pack, fill
    bound) pair, which read paths and shape signatures do not see."""
    pack, new = prev["ov_pack"], d["ov_pack"]
    if pack is not new and pack.shape == new.shape \
            and pack.device == new.device:
        d["ov_spare"] = (pack, _fill(prev))


# ---------------------------------------------------------------- point reads
def lookup_batch(arrs: dict, q: torch.Tensor, height: int = 3):
    """Batched point lookup of biased int64 queries: (payload int64 bits,
    found bool, leaf row int32).  K1 on the card, its plain version on the
    CPU."""
    return fused_lookup(arrs, None, q, height)


def lookup_batch_overlay(arrs: dict, ovr: dict, q: torch.Tensor,
                         height: int = 3):
    """Point lookup over snapshot + overlay: an overlay hit wins, a
    tombstone hides the key.  Same returns as :func:`lookup_batch`."""
    return fused_lookup(arrs, ovr, q, height)


# ---------------------------------------------------------------------- scans
def _scan_leaf_walk(leaf_keys, leaf_pay, leaf_count, leaf_next, leaf0, q,
                    count: int, max_blocks: int):
    """Gather ``max_blocks`` blocks along ``leaf_next`` from ``leaf0`` and
    compact the in-range entries (the reference's walk; the chain of rows
    is walked first, then every block's keys are gathered at once, and the
    payloads only of the ``count`` entries kept)."""
    L, cap = leaf_keys.shape
    Q = q.shape[0]
    chain = _walk_chain(leaf_next, leaf0, max_blocks)   # (Q, B)
    rows = chain.clamp(0, L - 1)
    valid = leaf_keys[rows] >= q[:, None, None]         # (Q, B, cap)
    valid &= torch.arange(cap, device=q.device) < leaf_count[rows][..., None]
    valid &= (chain >= 0)[..., None]
    valid = valid.reshape(Q, -1)
    order = _first_true(valid, count)
    flat = rows.gather(1, order // cap).long() * cap + order % cap
    return (leaf_keys.reshape(-1)[flat], leaf_pay.reshape(-1)[flat],
            valid.gather(1, order))


def _walk_chain(leaf_next: torch.Tensor, leaf0: torch.Tensor,
                max_blocks: int) -> torch.Tensor:
    """The ``max_blocks`` rows a scan visits from ``leaf0`` along
    ``leaf_next`` (-1 past the chain's end): (Q, max_blocks) int32."""
    L = leaf_next.shape[0]
    chain = []
    leaf = leaf0
    for _ in range(max_blocks):
        chain.append(leaf)
        leaf = torch.where(leaf >= 0, leaf_next[leaf.clamp(0, L - 1)], -1)
    return torch.stack(chain, 1)


def _first_true(mask: torch.Tensor, k: int) -> torch.Tensor:
    """The first ``k`` columns of ``torch.argsort(~mask, dim=1,
    stable=True)`` (a row's true columns in order, then its false ones),
    from prefix counts instead of a sort: the p-th true column is where
    the count of trues reaches p + 1, the p-th false one where the count
    of falses does.  Returns (Q, min(k, N)) int64."""
    Q, N = mask.shape
    k = min(k, N)
    dt = torch.int32 if N < 2**31 else torch.int64
    col = torch.arange(1, N + 1, device=mask.device, dtype=dt)
    t = mask.cumsum(1, dtype=dt)                  # trues in [0, c]
    p = torch.arange(1, k + 1, device=mask.device,
                     dtype=dt).expand(Q, k).contiguous()
    first = torch.searchsorted(t, p)
    nt = t[:, -1:].clone()
    t.neg_().add_(col)                            # falses in [0, c]
    rest = torch.searchsorted(t, p - nt)
    return torch.where(p <= nt, first, rest)


def scan_batch(arrs: dict, q: torch.Tensor, count: int = 100,
               height: int = 3, max_blocks: int | None = None):
    """Batched range scan: ``count`` pairs with key >= q[i] per query,
    walking the leaf sibling links from the start leaf K1 finds.  Returns
    (biased keys (Q, count), payload bits, valid mask)."""
    _, _, leaf0 = lookup_batch(arrs, q, height=height)
    cap = arrs["leaf_keys"].shape[1]
    if max_blocks is None:
        max_blocks = count // max(cap // 2, 1) + 2
    return _scan_leaf_walk(arrs["leaf_keys"], arrs["leaf_pay"],
                           arrs["leaf_count"], arrs["leaf_next"],
                           leaf0, q, count, max_blocks)


def scan_batch_overlay(arrs: dict, ovr: dict, q: torch.Tensor,
                       count: int = 100, height: int = 3,
                       max_blocks: int | None = None,
                       ov_bound: int | None = None):
    """Batched range scan over snapshot + overlay (two-way sorted merge), as
    the reference's ``scan_batch_overlay``: ``count + ov_bound`` snapshot
    candidates, the overlay's owned keys dropped, its live in-range entries
    unioned in, re-sorted.  ``ov_bound`` must be >= the overlay's occupied
    entries; the default is the padded capacity."""
    pack = ovr["ov_pack"]
    cap = pack.shape[1]
    hide = cap if ov_bound is None else min(int(ov_bound), cap)
    base = count + hide
    if max_blocks is not None:
        leaf_cap = arrs["leaf_keys"].shape[1]
        max_blocks = max_blocks + hide // max(leaf_cap // 2, 1) + 1
    # the candidates pass straight in, so the merge frees them once copied
    return _overlay_scan_merge(*scan_batch(arrs, q, count=base,
                                           height=height,
                                           max_blocks=max_blocks),
                               pack, q, count, hide)


def _overlay_scan_merge(ks, ps, vs, pack, q, count: int, hide: int):
    """Snapshot candidates the overlay owns lose; the overlay's live entries
    >= q union in; the result re-sorts.  Only the first ``hide`` overlay
    slots are unioned: past the occupied prefix every slot is padding, and
    padding columns sort after at least ``count`` snapshot columns, so they
    never reach the output — the result is the reference's, which unions
    the whole padded pack.

    The reference sorts every column of the union by (key, or ``BIASED_MAX``
    when not valid; column).  Its first ``count`` lie among the first
    ``count`` of each side in that order, and each side's are its columns
    with a key below ``BIASED_MAX`` in column order, which are ascending
    (the candidates arrive in key order, the pack is sorted), then the
    others in column order.  So each side is cut to ``count`` columns by
    prefix counts and only those 2 x ``count`` sort: the same result with
    temporaries of a few bytes a column, which sit on top of the engine's
    two overlay packs."""
    keys = pack[0]
    cap = keys.shape[0]
    pos = torch.searchsorted(keys, ks.contiguous())
    vs = vs & ~((pos < cap) & (keys[pos.clamp(0, cap - 1)] == ks))
    del pos
    side = _first_true(vs & (ks != BIASED_MAX), count)
    cand_k, cand_p, cand_v = ks.gather(1, side), ps.gather(1, side), \
        vs.gather(1, side)
    del ks, ps, vs
    keys, pays, tombs = keys[:hide], pack[1, :hide], pack[2, :hide] != 0
    ov_v = (keys[None, :] != BIASED_MAX) & ~tombs[None, :] \
        & (keys[None, :] >= q[:, None])
    side = _first_true(ov_v, count)
    comb_k = torch.cat([cand_k, keys[side]], 1)
    comb_p = torch.cat([cand_p, pays[side]], 1)
    comb_v = torch.cat([cand_v, ov_v.gather(1, side)], 1)
    sort_k = torch.where(comb_v, comb_k, BIASED_MAX)
    order = torch.argsort(sort_k, dim=1, stable=True)[:, :count]
    return (comb_k.gather(1, order), comb_p.gather(1, order),
            comb_v.gather(1, order))


# -------------------------------------------------------------------- overlay
def overlay_arrays(ov: DeltaOverlay, device=None,
                   prev: dict | None = None) -> dict:
    """Move the overlay to ``device`` as ONE packed (3, cap) transfer (into
    ``prev``'s spare when it fits: :func:`overlay_from_numpy`)."""
    a = ov.arrays()
    return overlay_from_numpy(
        np.stack([a["ov_keys"], a["ov_pay"], a["ov_tomb"].astype(np.uint64)]),
        device, fill=len(ov), prev=prev)


def overlay_arrays_merged(frozen: DeltaOverlay | None, live: DeltaOverlay,
                          device=None, prev: dict | None = None) -> dict:
    """Packed device overlay of ``frozen`` updated by ``live`` — the view
    served while a compaction is in flight.  Capacity is bucketed at >= 2x
    the live overlay's floor (one stable shape across freeze and swap), and
    ``n_live`` is the merged occupancy.  ``prev`` as for
    :func:`overlay_from_numpy`."""
    keys, pays, tomb = merge_overlays(frozen, live)
    n = keys.shape[0]
    cap = next_pow2(max(n, 2 * live.min_capacity))
    pack = np.zeros((3, cap), dtype=np.uint64)
    pack[0] = UINT64_MAX
    pack[0, :n] = keys
    pack[1, :n] = pays
    pack[2, :n] = tomb
    out = overlay_from_numpy(pack, device, fill=n, prev=prev)
    out["n_live"] = int(n)
    return out


def empty_overlay_pack(cap: int, device=None) -> torch.Tensor:
    """All-padding (3, cap) overlay pack built on the device."""
    pack = torch.zeros((3, cap), dtype=torch.int64, device=resolve(device))
    pack[0] = BIASED_MAX
    return pack


def merge_overlay_pack(ovr: dict, batch, cap_out: int,
                       live: int | None = None) -> tuple[dict, int]:
    """Absorb a drained host write batch (``DeltaOverlay.take_batch``) into
    the device-resident overlay pack: pad the sorted batch to a power-of-two
    bucket, ship only that (3, bcap) pack, merge on the device with
    ``overlay_merge`` (K2 on the card).  Returns (new overlay dict, bytes
    uploaded).

    The engines' two packs: the merge reads ``ovr["ov_pack"]`` and writes
    into ``ovr``'s spare (``ov_spare``: the pack served before it), then
    the two swap: the new dict serves the merged pack and keeps the pack
    it read as its spare, the next merge's target.  So a dict passed here
    stays valid until its successor is merged.  Every pack holds padding
    from its fill on (``ov_fill``: an upper bound of its live count: the
    fill before plus the batch, or ``live``, the caller's bound on the
    merged entries, when lower, as when the batch overwrites entries), and
    K2 pads only the target's slots past the merged count below that
    bound: a steady-state merge writes the live entries only.  A dict with
    no spare of ``cap_out`` slots (the first merge, or a capacity growth)
    drops it and merges into a fresh target, padded whole."""
    bk, bp, bt = batch
    n = int(bk.shape[0])
    bcap = next_pow2(max(n, 8))
    bpack = np.zeros((3, bcap), dtype=np.uint64)
    bpack[0] = UINT64_MAX
    bpack[0, :n] = bk
    bpack[1, :n] = bp
    bpack[2, :n] = bt
    pack, fill = ovr["ov_pack"], _fill(ovr)
    target, target_fill = _take_spare(ovr, cap_out, pack.device) or (
        torch.empty((3, cap_out), dtype=torch.int64, device=pack.device),
        cap_out)
    overlay_merge(pack, overlay_from_numpy(bpack, pack.device,
                                           fill=n)["ov_pack"],
                  cap_out, out=target, fill=fill, out_fill=target_fill)
    bound = min(cap_out, fill + n, cap_out if live is None else int(live))
    new = {"ov_pack": target, "ov_fill": bound}
    _keep_spare(new, ovr)
    return new, int(bpack.nbytes)


def update_leaf_rows(arrs: dict, di: DeviceIndex) -> dict:
    """Patch the device leaf pools after a fast-path refresh: only the rows
    in ``di.last_touched_rows`` (plus ``last_leaf_min``) are uploaded.  A
    full build (``last_touched_rows is None``) re-uploads every pool.  The
    patch is out of place, as in the reference: readers of ``arrs`` keep
    the old snapshot."""
    dev = arrs["leaf_keys"].device
    rows = di.last_touched_rows
    if rows is None:
        return device_arrays(di, dev)
    if len(rows):
        r = torch.from_numpy(np.asarray(rows, dtype=np.int64)).to(dev)
        arrs = dict(arrs)
        for f in ("leaf_keys", "leaf_pay", "leaf_count"):
            arrs[f] = arrs[f].index_copy(
                0, r, _pool_tensor(f, getattr(di, f)[rows], dev))
        arrs["last_leaf_min"] = _pool_tensor(
            "slot_key", np.array([di.last_leaf_min], dtype=np.uint64), dev)
    return arrs


# -------------------------------------------------------------------- sharded
# The range-sharded read path (DESIGN.md §9): the stacked pools of
# ``device_index.stack_device_indexes`` carry a leading shard axis; point
# reads route each query in K1 (``count(bounds < q)``) and read its shard's
# pools there, so no lane scatter is needed; scans walk the flattened
# (S*L, cap) leaf pools through ``leaf_next_chain`` from K1's global start
# leaf, crossing shard boundaries with no extra launch.

def stacked_device_arrays(sdi: StackedDeviceIndex, bounds_version: int = 0,
                          device=None) -> dict:
    """Move a stacked mirror's pools to ``device`` (default: the card):
    the ``(S, ...)`` pools in K1's layout, ``meta`` (S, 2), biased
    ``last_leaf_min`` (S,) and ``bounds`` (S-1,), and ``leaf_next_chain``
    (S*L,).  ``bounds_version`` records which boundary-table version the
    ``bounds`` belong to (DESIGN.md §12), for stats and tests."""
    dev = resolve(device)
    d = {f: _pool_tensor(f, getattr(sdi, f), dev) for f in _DEVICE_FIELDS}
    d["meta"] = _pool_tensor("meta", sdi.meta, dev)
    d["last_leaf_min"] = _pool_tensor("slot_key", sdi.last_leaf_min, dev)
    d["bounds"] = _pool_tensor("slot_key", sdi.bounds, dev)
    d["leaf_next_chain"] = _pool_tensor("leaf_next", sdi.leaf_next_chain,
                                        dev)
    d["bounds_version"] = int(bounds_version)
    return d


def upload_shard_slices(slices: dict, device) -> dict:
    """The pool slices of one shard (``device_index.pad_shard_slices``) on
    ``device``, ready for :func:`update_stacked_shard`'s ``dev_slices``."""
    dev = resolve(device)
    return {f: _pool_tensor(f, slices[f], dev) for f in _DEVICE_FIELDS}


def update_stacked_shard(stk: dict, sdi: StackedDeviceIndex,
                         shards: list[int],
                         dev_slices: dict | None = None) -> dict:
    """Patch the device copy of the stacked pools after ``restack_shard``
    refreshed the given shards: only those shards' slices are written
    (plus the small per-shard ``meta`` / ``last_leaf_min`` and the
    successor chain), so the device cost of a shard-local compaction is
    proportional to the hot shard.  ``dev_slices`` maps a shard id to its
    slices already on the device (:func:`upload_shard_slices`, from a
    background build); other shards upload from ``sdi``.

    The slices are written IN PLACE (``stk[f][s].copy_``), the torch form
    of the reference's donated install: every dict that shares those pool
    tensors — ``stk`` itself and any older snapshot of it — sees the new
    rows.  The returned dict is new only in ``meta``, ``last_leaf_min`` and
    ``leaf_next_chain``.  Callers that keep a snapshot across an install
    copy its pools first."""
    assert shards, "update_stacked_shard needs at least one changed shard"
    stk = dict(stk)
    dev = stk["leaf_keys"].device
    for s in shards:
        up = dev_slices.get(s) if dev_slices is not None else None
        for f in _DEVICE_FIELDS:
            row = up[f] if up is not None \
                else _pool_tensor(f, getattr(sdi, f)[s], dev)
            stk[f][s].copy_(row)
    stk["meta"] = _pool_tensor("meta", sdi.meta, dev)
    stk["last_leaf_min"] = _pool_tensor("slot_key", sdi.last_leaf_min, dev)
    stk["leaf_next_chain"] = _pool_tensor("leaf_next", sdi.leaf_next_chain,
                                          dev)
    return stk


def lookup_batch_sharded(stk: dict, q: torch.Tensor, height: int = 3):
    """Batched point lookup over a stacked mirror: (payload int64 bits,
    found bool, global leaf row ``sid * L + leaf`` int32, shard id int32).
    K1's shard route on the card, its plain version on the CPU."""
    return fused_lookup_sharded(stk, None, q, height)


def lookup_batch_sharded_overlay(stk: dict, ovr: dict, q: torch.Tensor,
                                 height: int = 3):
    """Sharded point lookup merged with the global overlay pack (shards
    partition the key space in order, so the shards' overlays concatenate
    into one sorted pack).  Returns (payload, found, global leaf row)."""
    return fused_lookup_sharded(stk, ovr, q, height)[:3]


def scan_batch_sharded(stk: dict, q: torch.Tensor, count: int = 100,
                       height: int = 3, max_blocks: int | None = None):
    """Batched range scan over a stacked mirror: the start leaf comes from
    K1's sharded read, the walk runs over the flattened (S*L, cap) leaf
    pools through the shard-successor chain, so a scan that exhausts its
    shard continues in the next shard's first leaf.  Returns (biased keys
    (Q, count), payload bits, valid mask)."""
    S = stk["meta"].shape[0]
    cap = stk["leaf_keys"].shape[2]
    if max_blocks is None:
        # + S: each shard boundary crossed can add one underfull chain leaf
        max_blocks = count // max(cap // 2, 1) + 2 + S
    _, _, gleaf, _ = lookup_batch_sharded(stk, q, height=height)
    return _scan_leaf_walk(stk["leaf_keys"].reshape(-1, cap),
                           stk["leaf_pay"].reshape(-1, cap),
                           stk["leaf_count"].reshape(-1),
                           stk["leaf_next_chain"], gleaf, q, count,
                           max_blocks)


def scan_batch_sharded_overlay(stk: dict, ovr: dict, q: torch.Tensor,
                               count: int = 100, height: int = 3,
                               max_blocks: int | None = None,
                               ov_bound: int | None = None):
    """Sharded range scan merged with the global overlay pack: the same
    two-way merge as :func:`scan_batch_overlay`, over the cross-shard leaf
    chain; ``ov_bound`` bounds the live overlay entries as there."""
    pack = ovr["ov_pack"]
    cap = pack.shape[1]
    hide = cap if ov_bound is None else min(int(ov_bound), cap)
    base = count + hide
    if max_blocks is not None:
        leaf_cap = stk["leaf_keys"].shape[2]
        max_blocks = max_blocks + hide // max(leaf_cap // 2, 1) + 1
    return _overlay_scan_merge(*scan_batch_sharded(stk, q, count=base,
                                                   height=height,
                                                   max_blocks=max_blocks),
                               pack, q, count, hide)


# ----------------------------------------------------------------------- mesh
# The mesh read path (DESIGN.md §13), the port of ``core/lookup.py:718-1057``
# of the reference: the stacked pools of a placed stack
# (``parallel.place_stacked``) lie as one slice of Sl = S / D shards on each
# mesh position, the boundary table and the cross-shard leaf chain whole on
# each.  A point read runs K1's shard route once for each position over its
# own shards (``kernels.fused_lookup.ops.fused_lookup_sharded_mesh``: the
# twin of both the reference's vmapped ``lookup_batch_sharded_mesh`` and
# its fused one, whose outputs are the same; the tensors' device picks the
# kernel or its plain version).  The reference's ``psum`` of disjoint
# contributions is a sum of the positions' results on the first device.
# The lane pack and its inverse (``_mesh_lane_pack``, ``_mesh_gather_back``)
# are K1's window there: the shard route needs one lane row, not (Sl, qcap).
#
# No counterpart: ``lookup_batch_sharded_mesh_packed`` and
# ``mesh_lookup_backend_fns`` are the reference's host-routed path of its jnp
# backend, and the port has no backend switch (the device picks the path).


def lookup_batch_sharded_mesh(mesh, stk: dict, q: torch.Tensor,
                              height: int = 3, qcap: int | None = None):
    """Mesh twin of :func:`lookup_batch_sharded`: (payload int64 bits,
    found bool, global leaf row int32, shard id int32) on the mesh's first
    device; queries no position owns (the sentinel) return zeros.
    ``qcap`` bounds the queries a shard owns (the engine's host route): a
    position reads a window of ``qcap * Sl`` of them."""
    return fused_lookup_sharded_mesh(mesh, stk, q, height, qcap)


def lookup_batch_sharded_overlay_mesh(mesh, stk: dict, ovr: dict,
                                      q: torch.Tensor, height: int = 3,
                                      qcap: int | None = None):
    """Mesh twin of :func:`lookup_batch_sharded_overlay`: the gathered
    snapshot results merge with the overlay pack on the mesh's first
    device through ``overlay_probe`` (K3 on the card), the place of the
    reference's ``_overlay_probe``.  K3 zeroes the payload of a query past
    the pack; the payload is read only where the query hit, so no output
    changes.  Returns (payload, found, global leaf row)."""
    pay, found, gleaf, _ = lookup_batch_sharded_mesh(mesh, stk, q, height,
                                                     qcap)
    opay, hit, tomb = overlay_probe(ovr, q)
    pay = torch.where(hit & ~tomb, opay, pay)
    found = torch.where(hit, ~tomb, found)
    return torch.where(found, pay, 0), found, gleaf


def _scan_leaf_walk_mesh(mesh, stk: dict, leaf0, q, count: int,
                         max_blocks: int, Sl: int):
    """:func:`_scan_leaf_walk` on the mesh: the rows the scans visit are
    walked once, on the first device over its copy of the replicated
    ``leaf_next_chain`` (every position would walk the same rows); each
    position marks the candidates in the rows it holds, and the marks OR
    on the first device (disjoint: a row lies on one position), which
    picks the first ``count``; then each position gathers the keys and
    payloads of the picked entries it holds, and those sum there."""
    L, cap = stk["leaf_keys"][0].shape[1:]
    n = Sl * L                                  # rows a position holds
    dev0, Q = q.device, q.shape[0]
    walk = _walk_chain(stk["leaf_next_chain"][0], leaf0, max_blocks)
    valid = torch.zeros((Q, max_blocks * cap), dtype=torch.bool,
                        device=dev0)
    walks = []
    for d, dev in enumerate(mesh.devices):
        chain = walk.to(dev)
        mine = (chain >= d * n) & (chain < (d + 1) * n)
        rows = (chain - d * n).clamp(0, n - 1)
        v = stk["leaf_keys"][d].reshape(-1, cap)[rows] \
            >= q.to(dev)[:, None, None]
        v &= torch.arange(cap, device=dev) \
            < stk["leaf_count"][d].reshape(-1)[rows][..., None]
        v &= mine[..., None]
        valid |= v.reshape(Q, -1).to(dev0)
        walks.append((mine, rows))
        del v
    order = _first_true(valid, count)
    keys = torch.zeros(order.shape, dtype=torch.int64, device=dev0)
    pays = torch.zeros_like(keys)
    for d, (dev, (mine, rows)) in enumerate(zip(mesh.devices, walks)):
        od = order.to(dev)
        held = mine.gather(1, od // cap)
        flat = rows.gather(1, od // cap).long() * cap + od % cap
        keys += torch.where(held, stk["leaf_keys"][d].reshape(-1)[flat],
                            0).to(dev0)
        pays += torch.where(held, stk["leaf_pay"][d].reshape(-1)[flat],
                            0).to(dev0)
    return keys, pays, valid.gather(1, order)


def scan_batch_sharded_mesh(mesh, stk: dict, q: torch.Tensor,
                            count: int = 100, height: int = 3,
                            max_blocks: int | None = None,
                            qcap: int | None = None):
    """Mesh twin of :func:`scan_batch_sharded`: the start leaves come from
    the mesh read, the walk runs on every position over its own rows
    (:func:`_scan_leaf_walk_mesh`).  Equal to the one-device scan where
    valid."""
    S = stk["bounds"][0].shape[0] + 1
    Sl = mesh_local_shards(S, mesh)
    cap = stk["leaf_keys"][0].shape[2]
    if max_blocks is None:
        # + S: each shard boundary crossed can add one underfull chain leaf
        max_blocks = count // max(cap // 2, 1) + 2 + S
    _, _, gleaf, _ = lookup_batch_sharded_mesh(mesh, stk, q, height=height,
                                               qcap=qcap)
    return _scan_leaf_walk_mesh(mesh, stk, gleaf, q, count, max_blocks, Sl)


def scan_batch_sharded_overlay_mesh(mesh, stk: dict, ovr: dict,
                                    q: torch.Tensor, count: int = 100,
                                    height: int = 3,
                                    max_blocks: int | None = None,
                                    qcap: int | None = None,
                                    ov_bound: int | None = None):
    """Mesh twin of :func:`scan_batch_sharded_overlay` (the same overlay
    window and two-way merge, on the mesh's first device, over the mesh
    scan)."""
    pack = ovr["ov_pack"]
    cap = pack.shape[1]
    hide = cap if ov_bound is None else min(int(ov_bound), cap)
    base = count + hide
    if max_blocks is not None:
        leaf_cap = stk["leaf_keys"][0].shape[2]
        max_blocks = max_blocks + hide // max(leaf_cap // 2, 1) + 1
    return _overlay_scan_merge(*scan_batch_sharded_mesh(
        mesh, stk, q, count=base, height=height, max_blocks=max_blocks,
        qcap=qcap), pack, q, count, hide)


def update_stacked_shard_mesh(mesh, stk: dict, sdi: StackedDeviceIndex,
                              shards: list[int],
                              dev_slices: dict | None = None) -> dict:
    """Mesh twin of :func:`update_stacked_shard`: each shard's slices are
    written IN PLACE into the local pools of the position that holds it
    (``copy_`` moves a slice uploaded elsewhere); then ``meta``,
    ``last_leaf_min`` and ``leaf_next_chain`` are placed anew
    (``parallel.place_stacked``).  The returned dict is new only in those
    three fields."""
    assert shards, "update_stacked_shard_mesh needs at least one shard"
    stk = dict(stk)
    Sl = mesh_local_shards(sdi.meta.shape[0], mesh)
    for s in shards:
        d, local = divmod(s, Sl)
        up = dev_slices.get(s) if dev_slices is not None else None
        for f in _DEVICE_FIELDS:
            row = up[f] if up is not None \
                else _pool_tensor(f, getattr(sdi, f)[s], mesh.devices[d])
            stk[f][d][local].copy_(row)
    cpu = torch.device("cpu")
    stk.update(place_stacked(
        {"meta": _pool_tensor("meta", sdi.meta, cpu),
         "last_leaf_min": _pool_tensor("slot_key", sdi.last_leaf_min, cpu),
         "leaf_next_chain": _pool_tensor("leaf_next", sdi.leaf_next_chain,
                                         cpu)}, mesh))
    return stk
