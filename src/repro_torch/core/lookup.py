"""Batched device read/write path over a :class:`DeviceIndex` mirror — the
port of ``src/repro/core/lookup.py:51-460`` (monolithic, S=1).

The mirror lives on one device as the dict that :func:`mirror_from_numpy`
builds: the pools of ``_STACK_2D + _STACK_3D`` in the layout the K1 kernel
reads directly (``kernels.fused_lookup.ops.POOL_DTYPES``), u64 keys biased
to int64 and payloads as int64 bits (``core.keys``).  The overlay is one
(3, cap) int64 pack: biased keys, payload bits, tombstones 0/1.

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
                                        overlay_probe_plain)
from ..kernels.overlay_merge.ops import merge_overlay_pack_torch, overlay_merge
from .delta_overlay import DeltaOverlay, UINT64_MAX, merge_overlays, next_pow2
from .device_index import _STACK_2D, _STACK_3D, DeviceIndex
from .keys import BIASED_MAX, bias_np

__all__ = ["STALE_STEPS", "TAG_NULL", "TAG_DATA", "TAG_PA", "TAG_BT",
           "TAG_MIXED", "device_arrays", "mirror_from_numpy",
           "overlay_from_numpy", "lookup_batch", "lookup_batch_overlay",
           "overlay_arrays", "overlay_arrays_merged",
           "merge_overlay_pack_torch", "empty_overlay_pack",
           "merge_overlay_pack", "update_leaf_rows", "scan_batch",
           "scan_batch_overlay"]

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


def overlay_from_numpy(pack, device=None) -> dict:
    """The port's overlay dict of a (3, cap) u64 overlay pack (keys,
    payloads, tombstones; ``UINT64_MAX`` key padding)."""
    pack = np.asarray(pack, dtype=np.uint64)
    out = np.empty(pack.shape, dtype=np.int64)
    out[0] = bias_np(pack[0])
    out[1] = pack[1].view(np.int64)
    out[2] = pack[2] != 0
    return {"ov_pack": torch.from_numpy(out).to(resolve(device))}


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


_overlay_probe = overlay_probe_plain


# ---------------------------------------------------------------------- scans
def _scan_leaf_walk(leaf_keys, leaf_pay, leaf_count, leaf_next, leaf0, q,
                    count: int, max_blocks: int):
    """Gather ``max_blocks`` blocks along ``leaf_next`` from ``leaf0`` and
    compact the in-range entries (the reference's walk; the chain of rows
    is walked first, then every block is gathered at once)."""
    L, cap = leaf_keys.shape
    Q = q.shape[0]
    chain = []
    leaf = leaf0
    for _ in range(max_blocks):
        chain.append(leaf)
        leaf = torch.where(leaf >= 0, leaf_next[leaf.clamp(0, L - 1)], -1)
    chain = torch.stack(chain, 1)                       # (Q, B)
    rows = chain.clamp(0, L - 1)
    ks = leaf_keys[rows]                                # (Q, B, cap)
    ps = leaf_pay[rows]
    cnt = leaf_count[rows]
    valid = ((torch.arange(cap, device=q.device) < cnt[..., None])
             & (ks >= q[:, None, None]) & (chain >= 0)[..., None])
    return _scan_compact(ks.reshape(Q, -1), ps.reshape(Q, -1),
                         valid.reshape(Q, -1), count)


def _scan_compact(out_k, out_p, out_v, count: int):
    """Valid entries first, in key order (a stable sort on the mask), then
    sliced to ``count``."""
    order = torch.argsort((~out_v).to(torch.uint8), dim=1,
                          stable=True)[:, :count]
    return (out_k.gather(1, order), out_p.gather(1, order),
            out_v.gather(1, order))


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
    ks, ps, vs = scan_batch(arrs, q, count=base, height=height,
                            max_blocks=max_blocks)
    return _overlay_scan_merge(ks, ps, vs, pack, q, count, hide)


def _overlay_scan_merge(ks, ps, vs, pack, q, count: int, hide: int):
    """Snapshot candidates the overlay owns lose; the overlay's live entries
    >= q union in; the result re-sorts.  Only the first ``hide`` overlay
    slots are unioned: past the occupied prefix every slot is padding, and
    padding columns sort after at least ``count`` snapshot columns, so they
    never reach the output — the result is the reference's, which unions
    the whole padded pack."""
    keys, pays, tombs = pack[0], pack[1], pack[2] != 0
    cap = keys.shape[0]
    pos = torch.searchsorted(keys, ks.contiguous())
    owned = (pos < cap) & (keys[pos.clamp(0, cap - 1)] == ks)
    vs = vs & ~owned
    Q = q.shape[0]
    keys, pays, tombs = keys[:hide], pays[:hide], tombs[:hide]
    ov_v = (keys[None, :] != BIASED_MAX) & ~tombs[None, :] \
        & (keys[None, :] >= q[:, None])
    comb_k = torch.cat([ks, keys[None, :].expand(Q, hide)], 1)
    comb_p = torch.cat([ps, pays[None, :].expand(Q, hide)], 1)
    comb_v = torch.cat([vs, ov_v], 1)
    sort_k = torch.where(comb_v, comb_k, BIASED_MAX)
    order = torch.argsort(sort_k, dim=1, stable=True)[:, :count]
    return (comb_k.gather(1, order), comb_p.gather(1, order),
            comb_v.gather(1, order))


# -------------------------------------------------------------------- overlay
def overlay_arrays(ov: DeltaOverlay, device=None) -> dict:
    """Move the overlay to ``device`` as ONE packed (3, cap) transfer."""
    a = ov.arrays()
    return overlay_from_numpy(
        np.stack([a["ov_keys"], a["ov_pay"], a["ov_tomb"].astype(np.uint64)]),
        device)


def overlay_arrays_merged(frozen: DeltaOverlay | None, live: DeltaOverlay,
                          device=None) -> dict:
    """Packed device overlay of ``frozen`` updated by ``live`` — the view
    served while a compaction is in flight.  Capacity is bucketed at >= 2x
    the live overlay's floor (one stable shape across freeze and swap), and
    ``n_live`` is the merged occupancy."""
    keys, pays, tomb = merge_overlays(frozen, live)
    n = keys.shape[0]
    cap = next_pow2(max(n, 2 * live.min_capacity))
    pack = np.zeros((3, cap), dtype=np.uint64)
    pack[0] = UINT64_MAX
    pack[0, :n] = keys
    pack[1, :n] = pays
    pack[2, :n] = tomb
    out = overlay_from_numpy(pack, device)
    out["n_live"] = int(n)
    return out


def empty_overlay_pack(cap: int, device=None) -> torch.Tensor:
    """All-padding (3, cap) overlay pack built on the device."""
    pack = torch.zeros((3, cap), dtype=torch.int64, device=resolve(device))
    pack[0] = BIASED_MAX
    return pack


def merge_overlay_pack(ovr: dict, batch, cap_out: int) -> tuple[dict, int]:
    """Absorb a drained host write batch (``DeltaOverlay.take_batch``) into
    the device-resident overlay pack: pad the sorted batch to a power-of-two
    bucket, ship only that (3, bcap) pack, merge on the device with
    ``overlay_merge`` (K2 on the card).  Returns (new overlay dict, bytes
    uploaded)."""
    bk, bp, bt = batch
    n = int(bk.shape[0])
    bcap = next_pow2(max(n, 8))
    bpack = np.zeros((3, bcap), dtype=np.uint64)
    bpack[0] = UINT64_MAX
    bpack[0, :n] = bk
    bpack[1, :n] = bp
    bpack[2, :n] = bt
    pack = ovr["ov_pack"]
    merged = overlay_merge(pack,
                           overlay_from_numpy(bpack, pack.device)["ov_pack"],
                           cap_out)
    return {"ov_pack": merged}, int(bpack.nbytes)


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
