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
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256          # the kernel keeps Dh / 32 values a lane


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
                   ctypes.c_int, ctypes.c_int,           # B, NP
                   ctypes.c_int, ctypes.c_int,           # P, page
                   ctypes.c_int, ctypes.c_int,           # H, Hkv
                   ctypes.c_int,                         # Dh
                   ctypes.c_longlong, ctypes.c_longlong,  # k, v page strides
                   ctypes.c_int,                         # dtype code
                   ctypes.c_void_p]                      # stream
    fn.restype = ctypes.c_int


def _check(table, lengths, q, k_pages, v_pages) -> None:
    dev = q.device
    if q.dtype not in _DTYPES or q.dim() != 3 or not q.is_contiguous():
        raise ValueError("q must be a contiguous (B, H, Dh) float32 or "
                         "bfloat16 tensor")
    B, H, Dh = q.shape
    if Dh > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {Dh} > {MAX_HEAD_DIM}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        # a page's (page, Hkv, Dh) block is contiguous; pages may be strided
        # (a layer's view of the (L, P, page, Hkv, Dh) pool)
        if t.device != dev or t.dtype != q.dtype or t.dim() != 4 \
                or t.shape != k_pages.shape or t.shape[3] != Dh \
                or t.shape[0] < 1 or t.stride()[1:] != (
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
            or not table.is_contiguous():
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

    CPU tensors run :func:`paged_attention_plain`; CUDA tensors launch K6
    (counted in ``paged_attention.launches``)."""
    if q.device.type == "cpu":
        return paged_attention_plain(table, lengths, q, k_pages, v_pages)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not "
                         f"{q.device}")
    _check(table, lengths, q, k_pages, v_pages)
    lib = _build.load("paged_attention", _bind)
    B, H, Dh = q.shape
    P, page, n_kv, _ = k_pages.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_attention_launch(
        table.data_ptr(), lengths.data_ptr(), q.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), out.data_ptr(),
        B, table.shape[1], P, page, H, n_kv, Dh, k_pages.stride(0),
        v_pages.stride(0), _DTYPES[q.dtype], stream)
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
