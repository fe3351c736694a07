"""K1 ``fused_lookup``: the whole batched point read (inner traversal, leaf
search, overlay merge) in one launch of ``csrc/fused_lookup.cu``, and its
plain PyTorch version.

Port of ``src/repro/kernels/fused_lookup/fused_lookup.py`` (the kernel) and
``src/repro/kernels/fused_lookup/ops.py:235-300`` (its host wrapper) at S=1.  The
mirror dict that ``core.lookup.mirror_from_numpy`` builds IS the kernel's
operand layout (:data:`POOL_DTYPES`), so there is no operand packing and no
operand cache.

Dispatch is by the query tensor's device: a CPU tensor runs
:func:`lookup_plain` (the twin of ``core/lookup.py:76-151, 391-423`` of the
reference), a CUDA tensor launches the kernel or raises.  Nothing falls
back.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.keys import key_f64
from .. import _build

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


# ------------------------------------------------------------ plain version
def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(t, idx, axis=0, mode="clip")``."""
    return t[idx.clamp(0, t.shape[0] - 1)]


def _row_search(pool: torch.Tensor, rows: torch.Tensor, q: torch.Tensor):
    """Whole-row rank: per query, the count of row ``rows[i]`` keys < q."""
    blk = _take(pool, rows)
    return blk, (blk < q[:, None]).sum(1, dtype=torch.int32)


def _pick(mat: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``mat[i, cols[i]]`` per row."""
    return mat.gather(1, cols.long()[:, None])[:, 0]


def overlay_probe_plain(pack: torch.Tensor, q: torch.Tensor):
    """(hit, tombstone, payload) of each query in the sorted (3, cap)
    overlay pack — ``_overlay_probe`` of the reference."""
    keys, pays, tombs = pack[0], pack[1], pack[2] != 0
    cap = keys.shape[0]
    pos = torch.searchsorted(keys, q)
    posc = pos.clamp(0, cap - 1)
    hit = (pos < cap) & (keys[posc] == q)
    return hit, hit & tombs[posc], pays[posc]


def lookup_plain(arrs: dict, ovr: dict | None, q: torch.Tensor,
                 height: int):
    """Plain PyTorch version of K1: (payload int64 bits, found bool, leaf
    row int32), operation for operation the reference's ``lookup_batch``
    followed by the overlay merge of ``lookup_batch_overlay``."""
    Q = q.shape[0]
    root, last_row = arrs["meta"][0], arrs["meta"][1]
    done = (q >= arrs["last_leaf_min"]) | (root < 0)
    node = root.clamp(min=0).expand(Q)
    leaf = torch.where(done, last_row, torch.full_like(q, -1,
                                                      dtype=torch.int32))
    qf = key_f64(q)
    S = arrs["slot_tag"].shape[0]
    pc = arrs["pa_ptrs"].shape[1]
    bc = arrs["bt_ptrs"].shape[1]
    for _ in range(height):
        base = _take(arrs["node_base"], node)
        fanout = _take(arrs["node_fanout"], node)
        slope = _take(arrs["node_slope"], node)
        inter = _take(arrs["node_intercept"], node)
        overflow = _take(arrs["node_overflow_slot"], node)
        pred = torch.minimum(
            torch.clamp(torch.floor(slope * qf + inter) - 1, min=0.0),
            (fanout - 1).to(torch.float64)).to(torch.int32)
        s = _take(arrs["next_occ"], base + pred)
        s = torch.where(s < 0, overflow, s)
        for _ in range(STALE_STEPS):
            sc = s.clamp(0, S - 1)
            stale = (s >= 0) & (arrs["slot_key"][sc] < q)
            s = torch.where(stale, arrs["succ_slot"][sc], s)
        ended = s < 0
        sc = s.clamp(0, S - 1)
        tag = arrs["slot_tag"][sc]
        ptr = arrs["slot_ptr"][sc]
        prow = ptr.clamp(min=0)
        _, pa_pos = _row_search(arrs["pa_keys"], prow, q)
        pa_hit = _pick(_take(arrs["pa_ptrs"], prow), pa_pos % pc)
        _, bt_pos = _row_search(arrs["bt_keys"], prow, q)
        bt_hit = _pick(_take(arrs["bt_ptrs"], prow), bt_pos % bc)
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
    blk, pos = _row_search(arrs["leaf_keys"], leaf, q)
    cap = blk.shape[1]
    posm = pos % cap
    found = (pos < cap) & (_pick(blk, posm) == q)
    pay = _pick(_take(arrs["leaf_pay"], leaf), posm)
    if ovr is not None:
        hit, tomb, opay = overlay_probe_plain(ovr["ov_pack"], q)
        pay = torch.where(hit & ~tomb, opay, pay)
        found = torch.where(hit, ~tomb, found)
    return torch.where(found, pay, 0), found, leaf


# ------------------------------------------------------------------ wrapper
def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.fused_lookup_launch
    fn.argtypes = ([ctypes.c_void_p] * len(_KERNEL_POOLS)
                   + [ctypes.c_int] * 8          # pool sizes
                   + [ctypes.c_void_p, ctypes.c_int,    # overlay pack, cap
                      ctypes.c_void_p, ctypes.c_int,    # queries, count
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int,       # height, stale
                      ctypes.c_void_p])                 # stream
    fn.restype = ctypes.c_int


def _check_operands(arrs: dict, ovr: dict | None, q: torch.Tensor) -> None:
    dev = q.device
    if q.dtype != torch.int64 or q.dim() != 1 or not q.is_contiguous():
        raise ValueError("queries must be a contiguous 1-D biased int64 "
                         "tensor")
    for f in _KERNEL_POOLS:
        t = arrs[f]
        if t.device != dev or t.dtype != POOL_DTYPES[f] \
                or not t.is_contiguous():
            raise ValueError(f"mirror pool {f!r}: want contiguous "
                             f"{POOL_DTYPES[f]} on {dev}, got {t.dtype} "
                             f"on {t.device}")
    for keys, ptrs in (("pa_keys", "pa_ptrs"), ("bt_keys", "bt_ptrs"),
                       ("leaf_keys", "leaf_pay")):
        if arrs[keys].dim() != 2 or arrs[keys].shape != arrs[ptrs].shape:
            raise ValueError(f"{keys}/{ptrs} must be equal 2-D shapes")
    if arrs["meta"].numel() != 2 or arrs["last_leaf_min"].numel() != 1:
        raise ValueError("meta must hold (root, last_row), last_leaf_min "
                         "one key")
    if ovr is not None:
        p = ovr["ov_pack"]
        if p.device != dev or p.dtype != torch.int64 or p.dim() != 2 \
                or p.shape[0] != 3 or p.shape[1] < 1 or not p.is_contiguous():
            raise ValueError("overlay pack must be a contiguous (3, cap) "
                             f"int64 tensor on {dev}")


def fused_lookup(arrs: dict, ovr: dict | None, q: torch.Tensor,
                 height: int):
    """Batched point read over the mirror ``arrs`` merged with the overlay
    ``ovr`` (None: snapshot only).  Returns (payload int64 bits, found
    bool, leaf row int32) for the biased int64 queries ``q``.

    CPU tensors run :func:`lookup_plain`; CUDA tensors launch K1 (counted in
    ``fused_lookup.launches``)."""
    if q.device.type == "cpu":
        return lookup_plain(arrs, ovr, q, height)
    if q.device.type != "cuda":
        raise ValueError(f"fused_lookup runs on cpu or cuda, not {q.device}")
    _check_operands(arrs, ovr, q)
    lib = _build.load("fused_lookup", _bind)
    Q = q.shape[0]
    pay = torch.empty(Q, dtype=torch.int64, device=q.device)
    found = torch.empty(Q, dtype=torch.bool, device=q.device)
    leaf = torch.empty(Q, dtype=torch.int32, device=q.device)
    if Q == 0:
        return pay, found, leaf
    sizes = (arrs["slot_tag"].shape[0], arrs["node_base"].shape[0],
             *arrs["pa_keys"].shape, *arrs["bt_keys"].shape,
             *arrs["leaf_keys"].shape)
    ov = ovr["ov_pack"] if ovr is not None else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.fused_lookup_launch(
        *[arrs[f].data_ptr() for f in _KERNEL_POOLS], *sizes,
        ov.data_ptr() if ov is not None else None,
        ov.shape[1] if ov is not None else 0,
        q.data_ptr(), Q, pay.data_ptr(), found.data_ptr(), leaf.data_ptr(),
        int(height), STALE_STEPS, stream)
    _build.check(err, "fused_lookup")
    fused_lookup.launches += 1
    return pay, found, leaf


fused_lookup.launches = 0
