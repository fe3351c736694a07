"""K4 ``leaf_search``: per query, the rank of the query in one row of a
sorted key pool, found, and the payload at that rank —
``csrc/leaf_search.cu`` and its plain PyTorch version.

Port of ``src/repro/kernels/leaf_search/leaf_search.py`` (the kernel),
``ref.py`` (its oracle) and ``ops.py`` (its host wrapper).  Keys are biased
int64 (``core.keys``), payloads int64 bits, so no u32 planes are split: the
PA/BT pools of the staged read pass their int32 ptrs widened to int64 where
the reference passes a zero hi plane.  As in the reference, the payload at
the rank is returned whether or not the key matches, and 0 when the rank
equals the row width.

Dispatch is by the query tensor's device: a CPU tensor runs
:func:`leaf_search_plain`, a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build


def leaf_search_plain(keys: torch.Tensor, pay: torch.Tensor,
                      rows: torch.Tensor, q: torch.Tensor):
    """Plain version of K4, the twin of ``leaf_search_ref``: gather each
    query's row, count keys < q, pick key and payload at that rank.  Rows
    are clamped into range."""
    cap = keys.shape[1]
    r = rows.long().clamp(0, keys.shape[0] - 1)
    blk = keys[r]
    pos = (blk < q[:, None]).sum(1)
    in_row = pos < cap
    posc = pos.clamp(max=cap - 1)
    found = in_row & (blk.gather(1, posc[:, None])[:, 0] == q)
    return torch.where(in_row, pay[r, posc], 0), found


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.leaf_search_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,     # keys, pay
                   ctypes.c_int, ctypes.c_int,           # rows, width
                   ctypes.c_void_p, ctypes.c_void_p,     # rows, queries
                   ctypes.c_int,                         # query count
                   ctypes.c_void_p, ctypes.c_void_p,     # out pay, found
                   ctypes.c_void_p]                      # stream
    fn.restype = ctypes.c_int


def _check(keys, pay, rows, q) -> None:
    dev = q.device
    if q.dtype != torch.int64 or q.dim() != 1 or not q.is_contiguous():
        raise ValueError("queries must be a contiguous 1-D biased int64 "
                         "tensor")
    if rows.device != dev or rows.dtype != torch.int32 \
            or rows.shape != q.shape or not rows.is_contiguous():
        raise ValueError(f"rows must be a contiguous int32 tensor of "
                         f"{tuple(q.shape)} on {dev}")
    for name, t in (("keys", keys), ("pay", pay)):
        if t.device != dev or t.dtype != torch.int64 or t.dim() != 2 \
                or t.shape[0] < 1 or t.shape[1] < 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (L>=1, C>=1) "
                             f"int64 tensor on {dev}")
    if keys.shape != pay.shape:
        raise ValueError("keys and pay must have equal shapes")


def leaf_search(keys: torch.Tensor, pay: torch.Tensor, rows: torch.Tensor,
                q: torch.Tensor):
    """Search row ``rows[i]`` of the sorted (L, C) biased-key pool ``keys``
    for ``q[i]``.  Returns (payload int64 bits at the rank, found bool).

    CPU tensors run :func:`leaf_search_plain`; CUDA tensors launch K4
    (counted in ``leaf_search.launches``)."""
    if q.device.type == "cpu":
        return leaf_search_plain(keys, pay, rows, q)
    if q.device.type != "cuda":
        raise ValueError(f"leaf_search runs on cpu or cuda, not {q.device}")
    _check(keys, pay, rows, q)
    lib = _build.load("leaf_search", _bind)
    Q = q.shape[0]
    out_pay = torch.empty(Q, dtype=torch.int64, device=q.device)
    found = torch.empty(Q, dtype=torch.bool, device=q.device)
    if Q == 0:
        return out_pay, found
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.leaf_search_launch(keys.data_ptr(), pay.data_ptr(),
                                 keys.shape[0], keys.shape[1],
                                 rows.data_ptr(), q.data_ptr(), Q,
                                 out_pay.data_ptr(), found.data_ptr(), stream)
    _build.check(err, "leaf_search")
    leaf_search.launches += 1
    return out_pay, found


leaf_search.launches = 0
