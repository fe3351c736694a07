"""K1 ``fused_lookup``: the whole batched point read (shard route, inner
traversal, leaf search, overlay merge) in one launch of
``csrc/fused_lookup.cu``, and its plain PyTorch version.

Port of ``src/repro/kernels/fused_lookup/fused_lookup.py`` (the kernel) and
``src/repro/kernels/fused_lookup/ops.py:235-300`` (its host wrapper).  Two
entry points share the kernel: :func:`fused_lookup` over a monolithic mirror
(``core.lookup.mirror_from_numpy``) and :func:`fused_lookup_sharded` over a
stacked ``(S, ...)`` shard mirror (``core.lookup.stacked_device_arrays``),
the TPU kernel's ``cfg.sharded`` branch; the monolithic mirror is the
one-shard stack.  Those dicts ARE the kernel's operand layout
(:data:`POOL_DTYPES`), so there is no operand packing and no operand cache.
:func:`fused_lookup_sharded_mesh` launches the shard route once for each
position of an index mesh, over that position's own shards (the
reference's ``_run_mesh``, ``ops.py:388-476``).
The kernel stages rows through shared memory; :func:`_stage_plan` sizes
it from the pools' shapes and raises where a leaf row cannot fit.
:func:`k1_bytes` is the bytes a launch must move, for its bound.

Dispatch is by the query tensor's device: a CPU tensor runs the plain
version (the twin of ``core/lookup.py:76-151, 391-423, 563-660`` of the
reference), a CUDA tensor launches the kernel or raises.  Nothing falls
back.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ...core.keys import BIASED_MAX, key_f64
from ...parallel.index_placement import mesh_local_shards
from .. import _build
from ..overlay_probe.ops import overlay_probe_plain

TAG_NULL, TAG_DATA, TAG_PA, TAG_BT, TAG_MIXED = 0, 1, 2, 3, 4
STALE_STEPS = 4  # successor-chain steps per level (the reference's bound)

# the mirror pools in kernel argument order, with their dtypes; keys are
# biased int64 (core.keys), payloads int64 bits
POOL_DTYPES = {
    "slot_tag": torch.int32, "slot_key": torch.int64,
    "slot_ptr": torch.int32, "next_occ": torch.int32,
    "succ_slot": torch.int32,
    "node_base": torch.int32, "node_fanout": torch.int32,
    "node_slope": torch.float64, "node_intercept": torch.float64,
    "node_overflow_slot": torch.int32,
    "pa_keys": torch.int64, "pa_ptrs": torch.int32,
    "bt_keys": torch.int64, "bt_ptrs": torch.int32,
    "leaf_keys": torch.int64, "leaf_pay": torch.int64,
    "leaf_count": torch.int32, "leaf_next": torch.int32,
    "meta": torch.int32, "last_leaf_min": torch.int64,
}
KEY_FIELDS = ("slot_key", "pa_keys", "bt_keys", "leaf_keys")
# pools the kernel reads (leaf_count / leaf_next serve scans only)
_KERNEL_POOLS = [f for f in POOL_DTYPES if f not in ("leaf_count",
                                                      "leaf_next")]
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak (NVIDIA data sheet)
STAGE_WARPS = 8             # warps a block: the kernel's __launch_bounds__
SMEM_BLOCK_MAX = 232_448    # dynamic shared memory one H100 block may use
# bits of the plan's ``wide``: that pool's rows copy 16 bytes at a time
WIDE_LEAF, WIDE_PA, WIDE_BT = 1, 2, 4


class StagePlan(NamedTuple):
    """How K1 stages rows through shared memory (``_stage_plan``)."""
    warps: int        # warps (queries) a block
    smem_bytes: int   # dynamic shared memory a block: a slice a warp
    slice_keys: int   # keys of a slice: a leaf row, rounded up to even
    wide: int         # WIDE_* bits of the pools copied 16 bytes at a time


# ------------------------------------------------------------ plain version
def _as_stack(arrs: dict) -> dict:
    """A monolithic mirror as a one-shard stack: every pool gains a leading
    shard axis of 1 (views, no copy) and the boundary table is empty."""
    stk = {f: arrs[f].unsqueeze(0) for f in _KERNEL_POOLS
           if f not in ("meta", "last_leaf_min")}
    stk["meta"] = arrs["meta"].reshape(1, 2)
    stk["last_leaf_min"] = arrs["last_leaf_min"].reshape(1)
    stk["bounds"] = arrs["last_leaf_min"].new_empty(0)
    return stk


def _at(sid, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Flat row of shard ``sid``'s entry ``idx`` in a stacked pool of ``n``
    rows a shard, with the reference's per-shard ``mode="clip"``: the index
    clamps inside the shard's own pool, then offsets by ``sid * n`` (the TPU
    kernel's ``sid * Nm + clip(node, 0, Nm - 1)``).  One shard (``sid`` is
    None) needs no offset.  Pools of one shape share the row."""
    idx = idx.clamp(0, n - 1)
    return idx if sid is None else sid * n + idx


def _row_search(keys: torch.Tensor, rows: torch.Tensor, q: torch.Tensor):
    """Whole-row rank: per query, the count of row ``rows[i]`` keys < q."""
    blk = keys[rows]
    return blk, (blk < q[:, None]).sum(1, dtype=torch.int32)


def _pick(mat: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``mat[i, cols[i]]`` per row."""
    return mat.gather(1, cols.long()[:, None])[:, 0]


def lookup_sharded_plain(stk: dict, ovr: dict | None, q: torch.Tensor,
                         height: int):
    """Plain PyTorch version of K1's sharded form: (payload int64 bits,
    found bool, global leaf row int32, shard id int32) over the stacked
    ``(S, ...)`` pools, operation for operation the reference's
    ``lookup_batch_sharded`` (a per-shard ``lookup_batch``; the global row
    is ``sid * L + leaf``) followed by the overlay merge of
    ``lookup_batch_sharded_overlay``."""
    S = stk["meta"].shape[0]
    # every pool as one flat (S * n, ...) view, indexed through _at
    fl = {f: stk[f].flatten(0, 1) for f in _KERNEL_POOLS
          if f not in ("meta", "last_leaf_min")}
    n = {f: stk[f].shape[1] for f in fl}
    if S == 1:
        # an empty boundary table sends every query to shard 0: no route,
        # no per-query meta gathers, no offsets
        sid = None
        root, last_row = stk["meta"][0, 0], stk["meta"][0, 1]
        lmin = stk["last_leaf_min"][0]
    else:
        # route: count(bounds < q) over the (S-1,) inclusive upper bounds,
        # the TPU kernel's compare-and-sum (== searchsorted(bounds, q,
        # "left"))
        sid = (stk["bounds"][None, :] < q[:, None]).sum(1)
        root, last_row = stk["meta"][sid, 0], stk["meta"][sid, 1]
        lmin = stk["last_leaf_min"][sid]
    done = (q >= lmin) | (root < 0)
    node = root.clamp(min=0).expand(q.shape)
    leaf = torch.where(done, last_row, torch.full_like(q, -1,
                                                      dtype=torch.int32))
    qf = key_f64(q)
    pc = stk["pa_ptrs"].shape[2]
    bc = stk["bt_ptrs"].shape[2]
    for _ in range(height):
        ni = _at(sid, node, n["node_base"])
        base = fl["node_base"][ni]
        fanout = fl["node_fanout"][ni]
        slope = fl["node_slope"][ni]
        inter = fl["node_intercept"][ni]
        overflow = fl["node_overflow_slot"][ni]
        pred = torch.minimum(
            torch.clamp(torch.floor(slope * qf + inter) - 1, min=0.0),
            (fanout - 1).to(torch.float64)).to(torch.int32)
        s = fl["next_occ"][_at(sid, base + pred, n["next_occ"])]
        s = torch.where(s < 0, overflow, s)
        for _ in range(STALE_STEPS):
            si = _at(sid, s, n["slot_key"])
            stale = (s >= 0) & (fl["slot_key"][si] < q)
            s = torch.where(stale, fl["succ_slot"][si], s)
        ended = s < 0
        si = _at(sid, s, n["slot_tag"])
        tag = fl["slot_tag"][si]
        ptr = fl["slot_ptr"][si]
        prow = ptr.clamp(min=0)
        pi = _at(sid, prow, n["pa_keys"])
        _, pa_pos = _row_search(fl["pa_keys"], pi, q)
        pa_hit = _pick(fl["pa_ptrs"][pi], pa_pos % pc)
        bi = _at(sid, prow, n["bt_keys"])
        _, bt_pos = _row_search(fl["bt_keys"], bi, q)
        bt_hit = _pick(fl["bt_ptrs"][bi], bt_pos % bc)
        is_mixed = (tag == TAG_MIXED) & ~ended
        step_leaf = torch.where(
            ended, last_row, torch.where(
                tag == TAG_DATA, ptr, torch.where(
                    tag == TAG_PA, pa_hit, torch.where(
                        tag == TAG_BT, bt_hit, -1))))
        newly = ~done & ~is_mixed
        leaf = torch.where(newly, step_leaf, leaf)
        done = done | newly
        node = torch.where(~done & is_mixed, ptr, node)

    leaf = leaf.clamp(min=0)
    li = _at(sid, leaf, n["leaf_keys"])
    blk, pos = _row_search(fl["leaf_keys"], li, q)
    cap = blk.shape[1]
    posm = pos % cap
    found = (pos < cap) & (_pick(blk, posm) == q)
    pay = _pick(fl["leaf_pay"][li], posm)
    if ovr is not None:
        opay, hit, tomb = overlay_probe_plain(ovr, q)
        pay = torch.where(hit & ~tomb, opay, pay)
        found = torch.where(hit, ~tomb, found)
    if sid is None:
        return torch.where(found, pay, 0), found, leaf, torch.zeros_like(leaf)
    gleaf = (sid * n["leaf_keys"] + leaf).to(torch.int32)
    return torch.where(found, pay, 0), found, gleaf, sid.to(torch.int32)


def lookup_plain(arrs: dict, ovr: dict | None, q: torch.Tensor,
                 height: int):
    """Plain PyTorch version of K1: (payload int64 bits, found bool, leaf
    row int32), operation for operation the reference's ``lookup_batch``
    followed by the overlay merge of ``lookup_batch_overlay`` — the
    sharded form over the mirror seen as a one-shard stack."""
    pay, found, leaf, _ = lookup_sharded_plain(_as_stack(arrs), ovr, q,
                                               height)
    return pay, found, leaf


# ------------------------------------------------------------------ wrapper
def _stage_plan(leaf_cap: int, pa_cap: int, bt_cap: int,
                aligned: tuple = (True, True, True)) -> StagePlan:
    """K1's shared-memory plan from the pools' row caps: each warp gets a
    slice of one leaf row (rounded up to an even count of keys, so slices
    stay 16-byte aligned), PA/BT rows pass through it in slice-sized
    chunks, and a block takes STAGE_WARPS warps, fewer where their slices
    would pass SMEM_BLOCK_MAX.  A pool's rows are copied 16 bytes at a
    time when its cap is even and its base (``aligned``: leaf, PA, BT) is
    16-byte aligned, 8 bytes otherwise.  Raises ``ValueError`` where not
    even one slice fits a block."""
    if min(leaf_cap, pa_cap, bt_cap) < 1:
        raise ValueError(f"empty K1 row caps leaf={leaf_cap} pa={pa_cap} "
                         f"bt={bt_cap}")
    slice_keys = leaf_cap + leaf_cap % 2
    warps = min(STAGE_WARPS, SMEM_BLOCK_MAX // (slice_keys * 8))
    if warps < 1:
        raise ValueError(f"K1 stages a leaf row in shared memory: a cap of "
                         f"{leaf_cap} keys ({slice_keys * 8} bytes) passes "
                         f"the {SMEM_BLOCK_MAX} bytes a block may use")
    wide = sum(bit for bit, cap, ok in zip((WIDE_LEAF, WIDE_PA, WIDE_BT),
                                           (leaf_cap, pa_cap, bt_cap),
                                           aligned) if cap % 2 == 0 and ok)
    return StagePlan(warps, warps * slice_keys * 8, slice_keys, wide)


_ROW_POOLS = ("leaf_keys", "pa_keys", "bt_keys")


def _launch_plan(stk: dict) -> StagePlan:
    """The plan a launch over the stacked pools ``stk`` uses: their row
    caps and whether each pool's base is 16-byte aligned."""
    return _stage_plan(*(stk[f].shape[2] for f in _ROW_POOLS),
                       tuple(stk[f].data_ptr() % 16 == 0 for f in _ROW_POOLS))


def k1_walks(arrs: dict, q: torch.Tensor) -> int:
    """Queries of ``q`` that enter the inner tree of their shard: a root is
    present and the key lies below the shard's last-leaf minimum.  The
    others read no node and no slot (the kernel's ``done`` at the route).
    ``arrs`` is a stacked mirror or a monolithic one."""
    stk = arrs if "bounds" in arrs else _as_stack(arrs)
    sid = (stk["bounds"][None, :] < q[:, None]).sum(1)
    walk = (q < stk["last_leaf_min"][sid]) & (stk["meta"][sid, 0] >= 0)
    return int(walk.sum())


def k1_bytes(Q: int, walks: int, rows: int, cap: int, overlay: bool,
             sharded: bool = False, n_bounds: int = 0) -> int:
    """Bytes a K1 launch must move on its data: queries in; payload, found,
    leaf row (and shard id) out; each of the ``rows`` distinct leaf rows'
    ``cap`` keys once and a payload word a query; one slot record
    (next_occ, key, tag, pointer: 20 bytes) for each of the ``walks``
    queries that enter the inner tree (:func:`k1_walks`); with an overlay,
    one overlay key a query; the boundary table."""
    return Q * (8 + (17 if sharded else 13) + 8 + (8 if overlay else 0)) \
        + walks * 20 + rows * cap * 8 + n_bounds * 8


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.fused_lookup_launch
    fn.argtypes = ([ctypes.c_void_p] * len(_KERNEL_POOLS)
                   + [ctypes.c_int] * 8          # per-shard pool sizes
                   + [ctypes.c_int, ctypes.c_void_p,    # shards, bounds
                      ctypes.c_void_p, ctypes.c_int,    # overlay pack, cap
                      ctypes.c_void_p, ctypes.c_int,    # queries, count
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p,                  # pay, found, leaf, sid
                      ctypes.c_int, ctypes.c_int,       # height, stale
                      ctypes.c_int, ctypes.c_int,       # plan: warps, bytes
                      ctypes.c_int, ctypes.c_int,       # slice keys, wide
                      ctypes.c_void_p])                 # stream
    fn.restype = ctypes.c_int


def _check_operands(stk: dict, ovr: dict | None, q: torch.Tensor) -> None:
    dev = q.device
    if q.dtype != torch.int64 or q.dim() != 1 or not q.is_contiguous():
        raise ValueError("queries must be a contiguous 1-D biased int64 "
                         "tensor")
    S = stk["meta"].shape[0]
    for f in _KERNEL_POOLS + ["bounds"]:
        t = stk[f]
        want = POOL_DTYPES.get(f, torch.int64)
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"mirror pool {f!r}: want contiguous {want} on "
                             f"{dev}, got {t.dtype} on {t.device}")
        if f != "bounds" and (t.dim() < 1 or t.shape[0] != S):
            raise ValueError(f"mirror pool {f!r} must lead with the {S} "
                             "shards")
    for keys, ptrs in (("pa_keys", "pa_ptrs"), ("bt_keys", "bt_ptrs"),
                       ("leaf_keys", "leaf_pay")):
        if stk[keys].dim() != 3 or stk[keys].shape != stk[ptrs].shape:
            raise ValueError(f"{keys}/{ptrs} must be equal (S, rows, cap) "
                             "shapes")
    if stk["meta"].shape != (S, 2) or stk["last_leaf_min"].shape != (S,) \
            or stk["bounds"].shape != (S - 1,):
        raise ValueError("meta must be (S, 2) (root, last row), "
                         "last_leaf_min (S,), bounds (S-1,)")
    for f in ("slot_tag", "node_base"):
        if stk[f].numel() >= 2**31:
            raise ValueError(f"K1 indexes the {f!r} pool in 32 bits: "
                             f"{stk[f].numel()} entries over all shards")
    if ovr is not None:
        p = ovr["ov_pack"]
        if p.device != dev or p.dtype != torch.int64 or p.dim() != 2 \
                or p.shape[0] != 3 or p.shape[1] < 1 or not p.is_contiguous():
            raise ValueError("overlay pack must be a contiguous (3, cap) "
                             f"int64 tensor on {dev}")


def _launch(stk: dict, ovr: dict | None, q: torch.Tensor, height: int,
            with_sid: bool):
    """One launch of ``csrc/fused_lookup.cu`` over the stacked pools:
    (payload, found, global leaf row[, shard id])."""
    _check_operands(stk, ovr, q)
    lib = _build.load("fused_lookup", _bind)
    Q, dev = q.shape[0], q.device
    pay = torch.empty(Q, dtype=torch.int64, device=dev)
    found = torch.empty(Q, dtype=torch.bool, device=dev)
    leaf = torch.empty(Q, dtype=torch.int32, device=dev)
    sid = torch.empty(Q, dtype=torch.int32, device=dev) if with_sid else None
    out = (pay, found, leaf) + ((sid,) if with_sid else ())
    if Q == 0:
        return out, False
    sizes = (stk["slot_tag"].shape[1], stk["node_base"].shape[1],
             *stk["pa_keys"].shape[1:], *stk["bt_keys"].shape[1:],
             *stk["leaf_keys"].shape[1:])
    S = stk["meta"].shape[0]
    bounds = stk["bounds"]
    ov = ovr["ov_pack"] if ovr is not None else None
    plan = _launch_plan(stk)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fused_lookup_launch(
        *[stk[f].data_ptr() for f in _KERNEL_POOLS], *sizes,
        S, bounds.data_ptr() if S > 1 else None,
        ov.data_ptr() if ov is not None else None,
        ov.shape[1] if ov is not None else 0,
        q.data_ptr(), Q, pay.data_ptr(), found.data_ptr(), leaf.data_ptr(),
        sid.data_ptr() if with_sid else None,
        int(height), STALE_STEPS, *plan, stream)
    _build.check(err, "fused_lookup")
    return out, True


def _on_card(q: torch.Tensor, name: str) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    return True


def fused_lookup(arrs: dict, ovr: dict | None, q: torch.Tensor,
                 height: int):
    """Batched point read over the mirror ``arrs`` merged with the overlay
    ``ovr`` (None: snapshot only).  Returns (payload int64 bits, found
    bool, leaf row int32) for the biased int64 queries ``q``.

    CPU tensors run :func:`lookup_plain`; CUDA tensors launch K1 (counted in
    ``fused_lookup.launches``)."""
    if not _on_card(q, "fused_lookup"):
        return lookup_plain(arrs, ovr, q, height)
    out, launched = _launch(_as_stack(arrs), ovr, q, height, False)
    fused_lookup.launches += launched
    return out


def fused_lookup_sharded(stk: dict, ovr: dict | None, q: torch.Tensor,
                         height: int):
    """Batched point read over the stacked shard mirror ``stk``
    (``core.lookup.stacked_device_arrays``) merged with the global overlay
    ``ovr`` (None: snapshot only): each query routes to its shard by
    ``count(bounds < q)`` and reads that shard's pools.  Returns (payload
    int64 bits, found bool, global leaf row ``sid * L + leaf`` int32, shard
    id int32).

    CPU tensors run :func:`lookup_sharded_plain`; CUDA tensors launch K1
    with its shard route (counted in ``fused_lookup_sharded.launches``)."""
    if not _on_card(q, "fused_lookup_sharded"):
        return lookup_sharded_plain(stk, ovr, q, height)
    out, launched = _launch(stk, ovr, q, height, True)
    fused_lookup_sharded.launches += launched
    return out


# ----------------------------------------------------------------------- mesh
# The mesh form (DESIGN.md §13), the twin of the reference's ``_run_mesh``
# and ``fused_lookup_batch_sharded_mesh`` (``kernels/fused_lookup/ops.py:
# 388-476``).  A placed stack (``parallel.place_stacked``) holds, for mesh
# position d, the pools of its Sl = S / D shards and a copy of the boundary
# table.  Each position routes the whole batch over that table, compacts the
# queries it owns into a window, and launches K1's shard route once over
# its own pools with the window of the table between its shards:
# ``bounds[d*Sl : d*Sl + Sl - 1]``.  The table is sorted, so for an owned
# query the kernel's ``count(bounds < q)`` over that window is its local
# shard id, and at Sl == 1 the window is empty and the kernel routes
# nothing.  So the reference's boundary planes padded to a common width
# (``MeshFusedOperands``) have no counterpart here: K1 takes the (Sl-1,)
# window as it is.  The positions' results go back to their batch slots
# and sum, disjoint, on the first device (the reference's ``psum``).


def _mesh_window(q: torch.Tensor, owned: torch.Tensor, window: int):
    """A position's window of the batch, the lane pack of the mesh read
    (the reference's ``_mesh_lane_pack`` with one lane row, as its fused
    path packs): the owned queries first in batch order (a stable sort),
    cut to ``window``, the slots past them the never-owned sentinel.
    Returns (window queries, their batch positions, the slots that hold an
    owned query)."""
    order = torch.argsort((~owned).to(torch.uint8), stable=True)[:window]
    keep = torch.arange(window, device=q.device) < owned.sum()
    return torch.where(keep, q[order], BIASED_MAX), order, keep


def _position(stk: dict, d: int, Sl: int) -> dict:
    """Mesh position ``d``'s operands: its own pools and the window of its
    copy of the boundary table between its shards (section comment)."""
    local = {f: stk[f][d] for f in _KERNEL_POOLS}
    local["bounds"] = stk["bounds"][d][d * Sl:d * Sl + Sl - 1]
    return local


def fused_lookup_sharded_mesh(mesh, stk: dict, q: torch.Tensor, height: int,
                              qcap: int | None = None):
    """Batched point read over a stacked mirror placed on the index mesh
    ``mesh``: (payload int64 bits, found bool, global leaf row int32, shard
    id int32) on the device of ``q``, the mesh's first.  Queries no
    position owns (the sentinel) return zeros.

    ``qcap`` is the per-shard routing bound (the engine's host route): a
    position's window is ``min(qcap * Sl, Q)`` queries.  Each position
    calls :func:`fused_lookup_sharded` once: K1 on a CUDA position (counted
    there and in ``fused_lookup_sharded_mesh.launches``), the plain version
    on a CPU one."""
    S = stk["bounds"][0].shape[0] + 1
    Sl = mesh_local_shards(S, mesh)
    L = stk["leaf_keys"][0].shape[1]
    Q, dev0 = q.shape[0], q.device
    window = Q if qcap is None else min(max(int(qcap) * Sl, 1), Q)
    pay = torch.zeros(Q, dtype=torch.int64, device=dev0)
    gleaf = torch.zeros(Q, dtype=torch.int32, device=dev0)
    sid = torch.zeros(Q, dtype=torch.int32, device=dev0)
    found = torch.zeros(Q, dtype=torch.int32, device=dev0)
    before = fused_lookup_sharded.launches
    for d, dev in enumerate(mesh.devices):
        qd = q.to(dev)
        local = torch.searchsorted(stk["bounds"][d], qd) - d * Sl
        owned = (local >= 0) & (local < Sl) & (qd != BIASED_MAX)
        qwin, order, keep = _mesh_window(qd, owned, window)
        p, f, lf, ls = fused_lookup_sharded(_position(stk, d, Sl), None,
                                            qwin, height)
        # the leaf row offset in 64 bits, then cut to 32 as the one-device
        # form's ``sid * L + leaf`` is
        lf = (lf.to(torch.int64) + d * Sl * L).to(torch.int32)
        # the gather back: each owned query's results at its batch slot,
        # summed into the outputs (disjoint: one position owns a query)
        order = order.to(dev0)
        for acc, v in ((pay, p), (found, f.to(torch.int32)), (gleaf, lf),
                       (sid, ls + d * Sl)):
            acc.index_add_(0, order, torch.where(keep, v, 0).to(dev0))
    fused_lookup_sharded_mesh.launches += fused_lookup_sharded.launches \
        - before
    return pay, found.bool(), gleaf, sid


fused_lookup.launches = 0
fused_lookup_sharded.launches = 0
fused_lookup_sharded_mesh.launches = 0
