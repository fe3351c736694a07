"""K6 ``paged_attention``: one GQA decode step over a paged KV pool —
``csrc/paged_attention.cu`` and its plain PyTorch version.

Port of ``src/repro/kernels/paged_attention/paged_attention.py`` (the
kernel), ``ref.py`` (its oracle) and ``ops.py`` (its host wrapper).
Shapes: ``table`` (B, NP) int32 physical page per logical page, ``lengths``
(B,) int32 live tokens per row, ``q`` (B, H, Dh), ``k_pages`` / ``v_pages``
(P, page, Hkv, Dh) float32 or bfloat16; the result is (B, H, Dh) in q's
dtype.  Query head ``h`` reads kv head ``h // (H // Hkv)``; the scale is
``1/sqrt(Dh)``; token ``p * page + i`` is live iff it is ``< lengths[b]``,
and dead logits are ``-1e30`` (so a row of length 0 is the plain mean of v
over all ``NP * page`` tokens of its table).  Page ids are clamped into
``[0, P)`` (the reference leaves them undefined out of range).

Dispatch is by the query tensor's device: a CPU tensor runs
:func:`paged_attention_plain`, a CUDA tensor launches the kernel or raises.
The kernel is split-K flash-decoding: :func:`_split_plan` cuts each row's
pages into splits from the static shapes alone, one block per (split,
query-head group, row) writes an ``(m, l, acc)`` partial, and a second
kernel of the same C call combines the splits.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dims the kernel is built for: every config's (64, 128, 256) and the
# tiny test configs' 32; each makes a token's row a whole number of 16-byte
# copies in both dtypes
HEAD_DIMS = (32, 64, 128, 256)
SPLIT_BLOCKS = 2048         # blocks a plan aims at over full rows (~16 an SM)
SPLIT_MIN_TOKENS = 32       # fewest tokens a split takes


def _split_plan(B: int, Hkv: int, NP: int, page: int) -> tuple[int, int]:
    """``(pages_per_split, n_splits)`` for K6: split each (row, kv head)'s
    NP logical pages into runs of consecutive pages, one block each, from
    the static shapes alone (the lengths stay on the card).  A split takes
    about ``B * Hkv * NP * page / SPLIT_BLOCKS`` tokens, at least
    ``SPLIT_MIN_TOKENS`` and at most the whole row; the last split may be
    short."""
    if min(B, Hkv, NP, page) < 1:
        raise ValueError(f"empty K6 geometry B={B} Hkv={Hkv} NP={NP} "
                         f"page={page}")
    tokens = max(SPLIT_MIN_TOKENS, -(-B * Hkv * NP * page // SPLIT_BLOCKS))
    pps = min(NP, -(-tokens // page))
    return pps, -(-NP // pps)


def _group(g: int) -> int:
    """Query heads one block takes: the largest of 8, 4, 2, 1 dividing the
    group size g (a block reads its kv head's pages once for all of them)."""
    return next(c for c in (8, 4, 2, 1) if g % c == 0)


def paged_attention_plain(table: torch.Tensor, lengths: torch.Tensor,
                          q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor) -> torch.Tensor:
    """Plain version of K6, the twin of ``paged_attention_ref``: gather the
    table's pages, a full float32 softmax under the ``-1e30`` length mask,
    the two einsums, cast to q's dtype."""
    B, H, Dh = q.shape
    P, page, n_kv, _ = k_pages.shape
    NP = table.shape[1]
    g = H // n_kv
    ids = table.reshape(-1).long().clamp(0, P - 1)
    k = k_pages[ids].reshape(B, NP * page, n_kv, Dh).float()
    v = v_pages[ids].reshape(B, NP * page, n_kv, Dh).float()
    qf = q.float().reshape(B, n_kv, g, Dh)
    logits = torch.einsum("bkgd,bskd->bkgs", qf, k) / torch.sqrt(
        torch.tensor(Dh, dtype=torch.float32))
    mask = torch.arange(NP * page, device=q.device)[None, :] \
        < lengths[:, None]
    logits = torch.where(mask[:, None, None, :], logits, -1e30)
    w = torch.exp(logits - logits.amax(-1, keepdim=True))
    w = w / w.sum(-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", w, v)
    return out.reshape(B, H, Dh).to(q.dtype)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.paged_attention_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,     # table, lengths
                   ctypes.c_void_p, ctypes.c_void_p,     # q, k pages
                   ctypes.c_void_p, ctypes.c_void_p,     # v pages, out
                   ctypes.c_void_p,                      # split partials
                   ctypes.c_int, ctypes.c_int,           # B, NP
                   ctypes.c_int, ctypes.c_int,           # P, page
                   ctypes.c_int, ctypes.c_int,           # H, Hkv
                   ctypes.c_int, ctypes.c_int,           # Dh, heads a block
                   ctypes.c_longlong, ctypes.c_longlong,  # k, v page strides
                   ctypes.c_int, ctypes.c_int,           # pages a split, splits
                   ctypes.c_int,                         # dtype code
                   ctypes.c_void_p]                      # stream
    fn.restype = ctypes.c_int


def _check(table, lengths, q, k_pages, v_pages) -> None:
    dev = q.device
    if q.dtype not in _DTYPES or q.dim() != 3 or not q.is_contiguous():
        raise ValueError("q must be a contiguous (B, H, Dh) float32 or "
                         "bfloat16 tensor")
    B, H, Dh = q.shape
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} is not one of {HEAD_DIMS}")
    elt = q.element_size()
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        # the kernel reads 16-byte pieces: 16-byte aligned bases and pages
        if t.data_ptr() % 16 or t.stride(0) * elt % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        # a page's (page, Hkv, Dh) block is contiguous; pages may be strided
        # (a layer's view of the (L, P, page, Hkv, Dh) pool)
        if t.device != dev or t.dtype != q.dtype or t.dim() != 4 \
                or t.shape != k_pages.shape or t.shape[3] != Dh \
                or t.shape[0] < 1 or t.shape[1] < 1 or t.stride()[1:] != (
                    t.shape[2] * Dh, Dh, 1):
            raise ValueError(f"{name} must be a (P, page, Hkv, {Dh}) "
                             f"{q.dtype} tensor on {dev} with contiguous "
                             "pages")
    n_kv = k_pages.shape[2]
    if H % n_kv:
        raise ValueError(f"{H} query heads do not group over {n_kv} kv "
                         "heads")
    if table.device != dev or table.dtype != torch.int32 \
            or table.dim() != 2 or table.shape[0] != B \
            or table.shape[1] < 1 or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous ({B}, NP) int32 "
                         f"tensor on {dev}")
    if lengths.device != dev or lengths.dtype != torch.int32 \
            or lengths.shape != (B,) or not lengths.is_contiguous():
        raise ValueError(f"lengths must be a contiguous ({B},) int32 tensor "
                         f"on {dev}")


def paged_attention(table: torch.Tensor, lengths: torch.Tensor,
                    q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor) -> torch.Tensor:
    """Flash-decoding over learned-index pages: (B, H, Dh) in q's dtype.

    CPU tensors run :func:`paged_attention_plain`; CUDA tensors launch K6,
    its split and combine kernels in one C call (counted once in
    ``paged_attention.launches``)."""
    if q.device.type == "cpu":
        return paged_attention_plain(table, lengths, q, k_pages, v_pages)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not "
                         f"{q.device}")
    _check(table, lengths, q, k_pages, v_pages)
    lib = _build.load("paged_attention", _bind)
    B, H, Dh = q.shape
    P, page, n_kv, _ = k_pages.shape
    NP = table.shape[1]
    out = torch.empty_like(q)
    if B == 0:
        return out
    pps, n_splits = _split_plan(B, n_kv, NP, page)
    # (m, l, acc) of every (row, query head, split): acc (B, H, n_splits,
    # Dh), then m and l (B, H, n_splits), float32
    part = torch.empty(B * H * n_splits * (Dh + 2), dtype=torch.float32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_attention_launch(
        table.data_ptr(), lengths.data_ptr(), q.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), out.data_ptr(),
        part.data_ptr(), B, NP, P, page, H, n_kv, Dh, _group(H // n_kv),
        k_pages.stride(0), v_pages.stride(0), pps, n_splits,
        _DTYPES[q.dtype], stream)
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
