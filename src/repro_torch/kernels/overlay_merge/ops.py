"""K2 ``overlay_merge``: the device-resident sorted-merge upsert of the
step's write batch into the overlay pack, in ``csrc/overlay_merge.cu``, and
its plain PyTorch version.

Port of ``src/repro/kernels/overlay_merge/overlay_merge.py`` and
``src/repro/kernels/overlay_merge/ops.py:32-65``.  The flat form
(:func:`overlay_merge`, the serving engines' write path) merges one (3, Cb)
batch into one (3, Ca) pack; the stacked form (:func:`overlay_merge_stacked`,
the reference's ``overlay_merge_pack_stacked``) merges S such rows, each on
its own, in one launch.  Packs are int64 in overlay layout: biased keys
(``INT64_MAX`` padding, sorted last), payload bits, tombstones 0/1.  Each
output row is bit-identical to the reference's ``merge_overlay_pack_jnp``:
the sorted union, the batch winning key collisions, tombstones kept as
entries, padding after the last live entry.

Dispatch is by device: CPU tensors run :func:`merge_overlay_pack_torch`,
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.keys import BIASED_MAX
from .. import _build


def merge_overlay_pack_torch(pack: torch.Tensor, batch: torch.Tensor,
                             cap_out: int) -> torch.Tensor:
    """Plain version of K2, operation for operation the reference's
    ``merge_overlay_pack_jnp``: output positions by rank arithmetic over
    both sorted inputs, then one disjoint scatter."""
    ak, bk = pack[0], batch[0]
    ca, cb = ak.shape[0], bk.shape[0]
    live_a = ak != BIASED_MAX
    live_b = bk != BIASED_MAX
    posb = torch.searchsorted(bk, ak)
    in_b = (posb < cb) & (bk[posb.clamp(0, cb - 1)] == ak)
    surv_a = live_a & ~in_b
    surv_i = surv_a.long()
    pos_a = torch.cumsum(surv_i, 0) - surv_i + posb
    live_bi = live_b.long()
    rank_b = torch.cumsum(live_bi, 0) - live_bi
    posa = torch.searchsorted(ak, bk)
    in_a = (posa < ca) & (ak[posa.clamp(0, ca - 1)] == bk)
    common = (live_b & in_a).long()
    pos_b = rank_b + posa - (torch.cumsum(common, 0) - common)
    out = torch.zeros((3, cap_out), dtype=torch.int64, device=pack.device)
    out[0] = BIASED_MAX
    keep_a = surv_a & (pos_a < cap_out)
    out[:, pos_a[keep_a]] = pack[:, keep_a]
    keep_b = live_b & (pos_b < cap_out)
    out[:, pos_b[keep_b]] = batch[:, keep_b]
    return out


def merge_overlay_stacked_torch(packs: torch.Tensor, batches: torch.Tensor,
                                cap_out: int) -> torch.Tensor:
    """Plain version of K2's stacked form: :func:`merge_overlay_pack_torch`
    on each shard row (the reference vmaps the same merge over rows)."""
    return torch.stack([merge_overlay_pack_torch(a, b, cap_out)
                        for a, b in zip(packs, batches)])


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.overlay_merge_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int,      # packs, Ca
                   ctypes.c_void_p, ctypes.c_int,      # batches, Cb
                   ctypes.c_void_p, ctypes.c_int,      # out, cap_out
                   ctypes.c_void_p, ctypes.c_int,      # int32 scratch, rows
                   ctypes.c_void_p]                    # stream
    fn.restype = ctypes.c_int


def _on_card(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")
    return True


def _launch(packs: torch.Tensor, batches: torch.Tensor,
            cap_out: int) -> torch.Tensor:
    """One launch of ``csrc/overlay_merge.cu`` over (S, 3, Ca) packs and
    (S, 3, Cb) batches: a rank block and a scatter grid row per shard."""
    dev = packs.device
    for t, name in ((packs, "packs"), (batches, "batches")):
        if t.device != dev or t.dtype != torch.int64 or t.dim() != 3 \
                or t.shape[0] != packs.shape[0] or t.shape[1] != 3 \
                or t.shape[2] < 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (S, 3, C>=1) "
                             f"int64 tensor on {dev}")
    S, _, ca = packs.shape
    cb = batches.shape[2]
    if cap_out < 1 or S < 1:
        raise ValueError("cap_out and the shard count must be >= 1")
    lib = _build.load("overlay_merge", _bind)
    out = torch.empty((S, 3, cap_out), dtype=torch.int64, device=dev)
    # a row's posa (Cb) | exclusive scan C (Cb + 1) | n_out, live pack count
    scratch = torch.empty(S * (2 * cb + 3), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.overlay_merge_launch(packs.data_ptr(), ca, batches.data_ptr(),
                                   cb, out.data_ptr(), cap_out,
                                   scratch.data_ptr(), S, stream)
    _build.check(err, "overlay_merge")
    return out


def overlay_merge(pack: torch.Tensor, batch: torch.Tensor,
                  cap_out: int) -> torch.Tensor:
    """Merge the sorted (3, Cb) write ``batch`` into the sorted (3, Ca)
    overlay ``pack``; returns a new (3, cap_out) pack.  ``cap_out`` must
    cover the merged live count (entries past it are dropped, as in the
    reference).  CPU tensors run the plain version; CUDA tensors launch K2
    (counted in ``overlay_merge.launches``)."""
    if not _on_card(pack, "overlay_merge"):
        return merge_overlay_pack_torch(pack, batch, cap_out)
    for t, name in ((pack, "pack"), (batch, "batch")):
        if t.dim() != 2:
            raise ValueError(f"{name} must be a (3, C) int64 tensor")
    out = _launch(pack[None], batch[None], int(cap_out))[0]
    overlay_merge.launches += 1
    return out


def overlay_merge_stacked(packs: torch.Tensor, batches: torch.Tensor,
                          cap_out: int) -> torch.Tensor:
    """Merge each shard row's sorted (3, Cb) batch of ``batches`` (S, 3,
    Cb) into its sorted (3, Ca) pack of ``packs`` (S, 3, Ca); returns new
    (S, 3, cap_out) packs, each row merged on its own.  ``cap_out`` must
    cover every row's merged live count.  CPU tensors run the plain
    version; CUDA tensors launch K2 over all rows at once (counted in
    ``overlay_merge_stacked.launches``)."""
    if not _on_card(packs, "overlay_merge_stacked"):
        return merge_overlay_stacked_torch(packs, batches, cap_out)
    out = _launch(packs, batches, int(cap_out))
    overlay_merge_stacked.launches += 1
    return out


overlay_merge.launches = 0
overlay_merge_stacked.launches = 0
