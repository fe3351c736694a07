"""K2 ``overlay_merge``: the device-resident sorted-merge upsert of the
step's write batch into the overlay pack, in ``csrc/overlay_merge.cu``, and
its plain PyTorch version.

Port of ``src/repro/kernels/overlay_merge/overlay_merge.py`` and
``src/repro/kernels/overlay_merge/ops.py:32-65``.  The flat form
(:func:`overlay_merge`, the serving engines' write path) merges one (3, Cb)
batch into one (3, Ca) pack; the stacked form (:func:`overlay_merge_stacked`,
the reference's ``overlay_merge_pack_stacked``) merges S such rows, each on
its own, in one launch; :func:`overlay_merge_stacked_mesh` runs it once
for each position of an index mesh over the position's rows.  Packs are
int64 in overlay layout: biased keys (``INT64_MAX`` padding, sorted last),
payload bits, tombstones 0/1.  Each output row is bit-identical to the
reference's ``merge_overlay_pack_jnp``: the sorted union, the batch winning
key collisions, tombstones kept as entries, padding after the last live
entry.

Both forms write either a fresh, fully padded pack or, given ``out``, into
a target the caller owns (the engines' two packs, ``core.lookup.
merge_overlay_pack``): a target holds padding in every slot from its fill
(the live count it last held, or an upper bound of it: ``out_fill``) to
its capacity, and the merge writes the merged entries into [0, n_out) and
padding into [n_out, out_fill) only, so that a steady-state merge moves
the live entries and not the padding.  ``fill`` bounds the pack's own
live count and sizes the grids.

Dispatch is by device: CPU tensors run the plain versions
(:func:`merge_overlay_pack_torch`, or :func:`merge_overlay_into_torch` with
``out``), CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.keys import BIASED_MAX
from ...parallel.index_placement import mesh_local_shards
from .. import _build

# the kernel scans a batch's overwrite flags in one block's shared memory
MAX_BATCH = 1 << 19


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


def _live(pack: torch.Tensor) -> int:
    return int((pack[0] != BIASED_MAX).sum())


def merge_overlay_into_torch(pack: torch.Tensor, batch: torch.Tensor,
                             cap_out: int, out: torch.Tensor,
                             out_fill: int | None = None,
                             fill: int | None = None) -> torch.Tensor:
    """Plain version of K2's merge into a target, with the kernel's write
    set: the merged entries of :func:`merge_overlay_pack_torch` into [0,
    n_out) of ``out`` (3, cap_out), padding into [n_out, out_fill) (default
    ``cap_out``: a fresh target), nothing past ``max(n_out, out_fill)``.
    ``fill``, when given, must bound the pack's live count, as the kernel
    requires.  Returns n_out, the target's new fill (an int32 scalar
    tensor)."""
    if out.shape != (3, cap_out):
        raise ValueError(f"out must be (3, {cap_out}), not {tuple(out.shape)}")
    if fill is not None and _live(pack) > fill:
        raise ValueError(f"fill {fill} is below the pack's live count "
                         f"{_live(pack)}")
    merged = merge_overlay_pack_torch(pack, batch, cap_out)
    n = _live(merged)
    hi = max(n, min(cap_out if out_fill is None else int(out_fill), cap_out))
    out[:, :hi] = merged[:, :hi]
    return torch.tensor(n, dtype=torch.int32, device=pack.device)


def merge_overlay_stacked_torch(packs: torch.Tensor, batches: torch.Tensor,
                                cap_out: int) -> torch.Tensor:
    """Plain version of K2's stacked form: :func:`merge_overlay_pack_torch`
    on each shard row (the reference vmaps the same merge over rows)."""
    return torch.stack([merge_overlay_pack_torch(a, b, cap_out)
                        for a, b in zip(packs, batches)])


def _per_row(v, rows: int, default: int) -> list[int]:
    """An int or one int a row, as a list of ``rows`` ints."""
    if v is None:
        return [default] * rows
    if isinstance(v, (list, tuple)):
        if len(v) != rows:
            raise ValueError(f"{len(v)} fills for {rows} rows")
        return [int(x) for x in v]
    return [int(v)] * rows


def merge_overlay_stacked_into_torch(packs: torch.Tensor,
                                     batches: torch.Tensor, cap_out: int,
                                     out: torch.Tensor, out_fill=None,
                                     fill=None) -> torch.Tensor:
    """Plain version of K2's stacked merge into a target:
    :func:`merge_overlay_into_torch` on each row of ``out`` (S, 3,
    cap_out), ``out_fill`` and ``fill`` an int or one a row.  Returns the
    rows' new fills (int32, (S,))."""
    S = packs.shape[0]
    return torch.stack([
        merge_overlay_into_torch(a, b, cap_out, o, f, fa) for a, b, o, f, fa
        in zip(packs, batches, out, _per_row(out_fill, S, cap_out),
               _per_row(fill, S, packs.shape[2]))])


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.overlay_merge_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int,      # packs, Ca
                   ctypes.c_int,                       # fill bound of packs
                   ctypes.c_void_p, ctypes.c_int,      # batches, Cb
                   ctypes.c_void_p, ctypes.c_int,      # out, cap_out
                   ctypes.c_void_p, ctypes.c_int,      # out fills, or one
                   ctypes.c_int,                       # their bound
                   ctypes.c_void_p, ctypes.c_int,      # int32 scratch, rows
                   ctypes.c_void_p]                    # stream
    fn.restype = ctypes.c_int


def _on_card(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")
    return True


def _span(t: torch.Tensor) -> tuple[int, int]:
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def _launch(packs: torch.Tensor, batches: torch.Tensor, cap_out: int,
            out: torch.Tensor, fill, out_fill) -> torch.Tensor:
    """One call of ``csrc/overlay_merge.cu`` (a rank launch and a scatter
    launch) over (S, 3, Ca) packs and (S, 3, Cb) batches into ``out`` (S,
    3, cap_out): ``fill`` bounds each pack row's live count (default Ca),
    ``out_fill`` each target row's fill (default cap_out: padded whole).
    Returns the rows' new fills, int32 (S,), on the card."""
    dev = packs.device
    for t, name in ((packs, "packs"), (batches, "batches"), (out, "out")):
        if t.device != dev or t.dtype != torch.int64 or t.dim() != 3 \
                or t.shape[0] != packs.shape[0] or t.shape[1] != 3 \
                or t.shape[2] < 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (S, 3, C>=1) "
                             f"int64 tensor on {dev}")
    S, _, ca = packs.shape
    cb = batches.shape[2]
    if out.shape[2] != cap_out or S < 1:
        raise ValueError(f"out must be (S>=1, 3, {cap_out})")
    if max(ca, cap_out) >= 2**31 - 1 or cb > MAX_BATCH:
        raise ValueError(f"K2 takes packs below 2^31 - 1 slots and batches "
                         f"of at most {MAX_BATCH} (Ca={ca}, Cb={cb}, "
                         f"cap_out={cap_out})")
    o0, o1 = _span(out)
    for t in (packs, batches):
        t0, t1 = _span(t)
        if t0 < o1 and o0 < t1:
            raise ValueError("out must not overlap the pack or the batch")
    fa = max(_per_row(fill, S, ca))
    if not 0 <= fa <= ca:
        raise ValueError(f"fill must lie in [0, {ca}], not {fa}")
    fills = [min(max(f, 0), cap_out) for f in _per_row(out_fill, S, cap_out)]
    lib = _build.load("overlay_merge", _bind)
    per_row = None
    if len(set(fills)) > 1:
        per_row = torch.tensor(fills, dtype=torch.int32).to(dev)
    # a row's posa (Cb) | flags (Cb) | n_live_a | n_out
    scratch = torch.empty((S, 2 * cb + 2), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.overlay_merge_launch(
        packs.data_ptr(), ca, fa, batches.data_ptr(), cb, out.data_ptr(),
        cap_out, per_row.data_ptr() if per_row is not None else None,
        fills[0], max(fills), scratch.data_ptr(), S, stream)
    _build.check(err, "overlay_merge")
    return scratch[:, 2 * cb + 1]


def overlay_merge(pack: torch.Tensor, batch: torch.Tensor, cap_out: int,
                  out: torch.Tensor | None = None, fill: int | None = None,
                  out_fill: int | None = None):
    """Merge the sorted (3, Cb) write ``batch`` into the sorted (3, Ca)
    overlay ``pack``.  ``cap_out`` must cover the merged live count
    (entries past it are dropped, as in the reference).

    Without ``out``: returns a new, fully padded (3, cap_out) pack.  With
    ``out``, a (3, cap_out) target holding padding from ``out_fill``
    (default ``cap_out``) on, neither overlapping the inputs: the merge is
    written into it (its [0, n_out), and padding into [n_out, out_fill)),
    and the call returns n_out, its new fill (an int32 scalar tensor), as
    :func:`merge_overlay_into_torch` does.  ``fill`` (default Ca) must
    bound the pack's live count.  CPU tensors run the plain versions; CUDA
    tensors launch K2 (counted in ``overlay_merge.launches``)."""
    if not _on_card(pack, "overlay_merge"):
        if out is None:
            return merge_overlay_pack_torch(pack, batch, cap_out)
        return merge_overlay_into_torch(pack, batch, cap_out, out, out_fill,
                                        fill)
    for t, name in ((pack, "pack"), (batch, "batch"), (out, "out")):
        if t is not None and t.dim() != 2:
            raise ValueError(f"{name} must be a (3, C) int64 tensor")
    cap_out = int(cap_out)
    target = out if out is not None else torch.empty(
        (3, cap_out), dtype=torch.int64, device=pack.device)
    fills = _launch(pack[None], batch[None], cap_out, target[None], fill,
                    out_fill if out is not None else cap_out)
    overlay_merge.launches += 1
    return target if out is None else fills[0]


def overlay_merge_stacked(packs: torch.Tensor, batches: torch.Tensor,
                          cap_out: int, out: torch.Tensor | None = None,
                          fill=None, out_fill=None):
    """Merge each shard row's sorted (3, Cb) batch of ``batches`` (S, 3,
    Cb) into its sorted (3, Ca) pack of ``packs`` (S, 3, Ca), each row on
    its own.  ``cap_out`` must cover every row's merged live count.
    Without ``out``: returns new, fully padded (S, 3, cap_out) packs.  With
    ``out`` (S, 3, cap_out), whose rows hold padding from ``out_fill`` (an
    int or one a row; default ``cap_out``) on: the merge is written into
    it, and the call returns the rows' new fills (int32, (S,)), as
    :func:`merge_overlay_stacked_into_torch` does.  ``fill`` (an int or one
    a row, default Ca) bounds the rows' live counts.  CPU tensors run the
    plain versions; CUDA tensors launch K2 over all rows at once (counted in
    ``overlay_merge_stacked.launches``)."""
    if not _on_card(packs, "overlay_merge_stacked"):
        if out is None:
            return merge_overlay_stacked_torch(packs, batches, cap_out)
        return merge_overlay_stacked_into_torch(packs, batches, cap_out, out,
                                                out_fill, fill)
    cap_out = int(cap_out)
    target = out if out is not None else torch.empty(
        (packs.shape[0], 3, cap_out), dtype=torch.int64, device=packs.device)
    fills = _launch(packs, batches, cap_out, target, fill,
                    out_fill if out is not None else cap_out)
    overlay_merge_stacked.launches += 1
    return target if out is None else fills


def overlay_merge_stacked_mesh(mesh, packs: torch.Tensor,
                               batches: torch.Tensor,
                               cap_out: int) -> torch.Tensor:
    """The stacked merge on an index mesh, the twin of the reference's
    ``overlay_merge_pack_stacked_mesh`` (``ops.py:68-83``): mesh position
    d merges only its own rows ``[d*Sl, (d+1)*Sl)`` of ``packs`` (S, 3, Ca)
    and ``batches`` (S, 3, Cb), moved to its device, through
    :func:`overlay_merge_stacked`; returns new, fully padded (S, 3,
    cap_out) packs on the device of ``packs``, which a position there
    merges into directly (its rows of the result) and any other copies its
    rows back to.  S must be divisible by the mesh's positions.  One K2
    launch a CUDA position (counted there and in
    ``overlay_merge_stacked_mesh.launches``); as in the reference, no
    engine calls it."""
    Sl = mesh_local_shards(packs.shape[0], mesh)
    out = torch.empty((packs.shape[0], 3, int(cap_out)), dtype=packs.dtype,
                      device=packs.device)
    before = overlay_merge_stacked.launches
    for d, dev in enumerate(mesh.devices):
        rows = slice(d * Sl, (d + 1) * Sl)
        if dev == packs.device:
            overlay_merge_stacked(packs[rows], batches[rows], cap_out,
                                  out=out[rows])
        else:
            out[rows].copy_(overlay_merge_stacked(
                packs[rows].to(dev), batches[rows].to(dev), cap_out))
    overlay_merge_stacked_mesh.launches += overlay_merge_stacked.launches \
        - before
    return out


overlay_merge.launches = 0
overlay_merge_stacked.launches = 0
overlay_merge_stacked_mesh.launches = 0
