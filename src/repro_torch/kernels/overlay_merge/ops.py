"""K2 ``overlay_merge``: the device-resident sorted-merge upsert of the
step's write batch into the overlay pack, in ``csrc/overlay_merge.cu``, and
its plain PyTorch version.

Port of ``src/repro/kernels/overlay_merge/overlay_merge.py`` and
``src/repro/kernels/overlay_merge/ops.py:32-65`` at S=1.  Both operands are
(3, C) int64 packs in overlay layout: biased keys (``INT64_MAX`` padding,
sorted last), payload bits, tombstones 0/1.  The output is bit-identical to
the reference's ``merge_overlay_pack_jnp``: the sorted union, the batch
winning key collisions, tombstones kept as entries, padding after the last
live entry.

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


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.overlay_merge_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int,      # pack, Ca
                   ctypes.c_void_p, ctypes.c_int,      # batch, Cb
                   ctypes.c_void_p, ctypes.c_int,      # out, cap_out
                   ctypes.c_void_p,                    # int32 scratch
                   ctypes.c_void_p]                    # stream
    fn.restype = ctypes.c_int


def _check(t: torch.Tensor, name: str, dev: torch.device) -> None:
    if t.device != dev or t.dtype != torch.int64 or t.dim() != 2 \
            or t.shape[0] != 3 or t.shape[1] < 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (3, C>=1) int64 "
                         f"tensor on {dev}")


def overlay_merge(pack: torch.Tensor, batch: torch.Tensor,
                  cap_out: int) -> torch.Tensor:
    """Merge the sorted (3, Cb) write ``batch`` into the sorted (3, Ca)
    overlay ``pack``; returns a new (3, cap_out) pack.  ``cap_out`` must
    cover the merged live count (entries past it are dropped, as in the
    reference).  CPU tensors run the plain version; CUDA tensors launch K2
    (counted in ``overlay_merge.launches``)."""
    if pack.device.type == "cpu":
        return merge_overlay_pack_torch(pack, batch, cap_out)
    if pack.device.type != "cuda":
        raise ValueError(f"overlay_merge runs on cpu or cuda, not "
                         f"{pack.device}")
    _check(pack, "pack", pack.device)
    _check(batch, "batch", pack.device)
    cap_out = int(cap_out)
    if cap_out < 1:
        raise ValueError("cap_out must be >= 1")
    lib = _build.load("overlay_merge", _bind)
    ca, cb = pack.shape[1], batch.shape[1]
    out = torch.empty((3, cap_out), dtype=torch.int64, device=pack.device)
    # posa (Cb) | exclusive scan C (Cb + 1) | n_out, live pack count
    scratch = torch.empty(2 * cb + 3, dtype=torch.int32, device=pack.device)
    stream = torch.cuda.current_stream(pack.device).cuda_stream
    err = lib.overlay_merge_launch(pack.data_ptr(), ca, batch.data_ptr(), cb,
                                   out.data_ptr(), cap_out,
                                   scratch.data_ptr(), stream)
    _build.check(err, "overlay_merge")
    overlay_merge.launches += 1
    return out


overlay_merge.launches = 0
