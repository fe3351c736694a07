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

The kernel searches each row (it is sorted, padding last) with a group of
:func:`k4_lanes` lanes a query; :func:`k4_walk` re-walks that search on
the tensors, and :func:`k4_bytes` counts what the function must move.

Dispatch is by the query tensor's device: a CPU tensor runs
:func:`leaf_search_plain`, a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..overlay_probe.ops import lower_bound_rounds


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


MAX_LANES = 16        # K4's lanes a query at most
THREADS_PER_SM = 256  # the batch's threads past which K4 takes fewer lanes
SECTOR = 32           # bytes of the memory system's smallest read


def k4_lanes(C: int, Q: int, sms: int) -> int:
    """K4's lanes a query for a batch of ``Q`` rows of width ``C`` on
    ``sms`` SMs: ``MAX_LANES``, no more than a power of two that covers
    the row (more lanes than keys load nothing: one round either way), and
    halved while the batch's ``Q * lanes`` threads pass one 256-thread
    block an SM; 1 (a binary search) from ``sms * 256`` queries.  On an
    H100 (132 SMs): 16 lanes to 2,112 queries, 8 to 4,224, 4 to 8,448, 2
    to 16,896, then 1.

    Why (``python -m repro_torch.launch.time_plain --staged``, device ms
    in turns, L2 flushed; H100 80GB HBM3, 700 W; PERF.md §6): at the
    staged read's 8192 queries on 256-key leaf rows, 1, 2, 4, 8 and 16
    lanes took 0.0117, 0.0107-0.0108, 0.0109-0.0111, 0.0119 and 0.0131
    ms: fewer lanes touch fewer sectors and take more rounds.  At 256 and
    1024 queries the rounds rule (8-16 lanes 0.0073 and 0.0079-0.0082, 1
    lane 0.0099-0.0102 and 0.0102-0.0104); from 32,768 queries one lane
    is fastest (0.0182-0.0184 against 4 lanes' 0.0202-0.0203).  Rows of
    64 and 1020 keys crossed over at about the same batch sizes, so the
    width sets no lanes beyond the cover."""
    lanes = MAX_LANES
    while lanes > 1 and (lanes >= 2 * C
                         or Q * lanes > sms * THREADS_PER_SM):
        lanes //= 2
    return lanes


def k4_trips(C: int, lanes: int) -> int:
    """Dependent round trips a query, counted from the source, not
    measured: the query and its row id, the search's rounds over ``C`` keys
    (its longest path, ``lower_bound_rounds``), the key and payload at the
    rank."""
    return 1 + lower_bound_rounds(C, lanes) + 1


def k4_walk(keys: torch.Tensor, rows: torch.Tensor, q: torch.Tensor,
            lanes: int):
    """K4's search as the kernel's group runs it (``group_lower_bound``
    over each query's row, all queries at once): (rank int64, rounds int64
    a query, the distinct ``SECTOR``-byte sectors of ``keys`` its splitter
    loads touch, as addresses // ``SECTOR``).  The key at a rank below C
    lies among them: the top of a search's interval is always a splitter
    it loaded and found not below q, or C."""
    L, C = keys.shape
    flat = keys.reshape(-1)
    base = rows.long().clamp(0, L - 1) * C
    lo = torch.zeros_like(base)
    n = torch.full_like(base, C)
    rounds = torch.zeros_like(base)
    part = torch.arange(1, lanes + 1, device=keys.device)
    touched = []
    while bool((n > 0).any()):
        step = n // (lanes + 1) + 1
        j = part * step[:, None] - 1
        ok = j < n[:, None]
        at = base[:, None] + lo[:, None] + j
        below = ok & (flat[torch.where(ok, at, 0)] < q[:, None])
        touched.append(at[ok])
        rounds += n > 0
        c = below.sum(1)
        lo += c * step
        n = torch.minimum(step - 1, n - c * step)
    at = torch.cat(touched) if touched else base[:0]
    sectors = torch.unique((keys.data_ptr() + 8 * at) // SECTOR)
    return lo, rounds, sectors


def k4_least_sectors(keys: torch.Tensor, rows: torch.Tensor,
                     q: torch.Tensor) -> tuple[int, int]:
    """The fewest sectors of ``keys`` the search of these queries needs,
    whatever lanes a launch takes: the least over 1-32 lanes a query of
    what :func:`k4_walk` touches, and the lanes that give it.  The search
    bound counts these, so that a change of :func:`k4_lanes` moves the
    time and not the yardstick."""
    return min((int(k4_walk(keys, rows, q, g)[2].numel()), g)
               for g in (1, 2, 4, 8, 16, 32))


def k4_bytes(Q: int, sectors: int, in_row: int) -> int:
    """Bytes a K4 launch must move on its data (the search bound): a
    query's key and row id in, the ``sectors`` of keys its search reads
    (:func:`k4_least_sectors`; the key at the rank lies in one of them), the
    payload at the rank for the ``in_row`` queries whose rank is below C,
    payload and found out."""
    return Q * (8 + 4 + 9) + SECTOR * sectors + 8 * in_row


def k4_row_bytes(Q: int, rows: int, C: int) -> int:
    """The whole-row bound: each of the ``rows`` distinct rows read whole,
    and per query its row id, key, the payload at the rank, payload and
    found out (the first port's count)."""
    return rows * C * 8 + Q * (4 + 8 + 8 + 9)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.leaf_search_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,     # keys, pay
                   ctypes.c_int, ctypes.c_int,           # rows, width
                   ctypes.c_void_p, ctypes.c_void_p,     # rows, queries
                   ctypes.c_int,                         # query count
                   ctypes.c_void_p, ctypes.c_void_p,     # out pay, found
                   ctypes.c_int,                         # lanes a query
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
    (each row sorted, padding last) for ``q[i]``.  Returns (payload int64
    bits at the rank, found bool).

    CPU tensors run :func:`leaf_search_plain`; CUDA tensors launch K4 with
    :func:`k4_lanes` lanes a query, counted in ``leaf_search.launches``."""
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
    lanes = k4_lanes(keys.shape[1], Q, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    err = lib.leaf_search_launch(keys.data_ptr(), pay.data_ptr(),
                                 keys.shape[0], keys.shape[1],
                                 rows.data_ptr(), q.data_ptr(), Q,
                                 out_pay.data_ptr(), found.data_ptr(), lanes,
                                 stream)
    _build.check(err, "leaf_search")
    leaf_search.launches += 1
    return out_pay, found


leaf_search.launches = 0
