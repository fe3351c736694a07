"""K3 ``overlay_probe``: per query, the rank in the sorted delta-overlay
pack and the overlay's verdict there — ``csrc/overlay_probe.cu`` and its
plain PyTorch version.

Port of ``src/repro/kernels/overlay_probe/overlay_probe.py`` (the kernel),
``ref.py`` (its oracle) and ``ops.py`` (its host wrapper) over the port's
overlay dict, ``{"ov_pack": (3, cap) int64}`` (biased keys with
``INT64_MAX`` padding sorted last, payload bits, tombstones 0/1), as
``core.lookup.overlay_arrays`` / ``overlay_from_numpy`` build it.  Callers
take the overlay payload when ``hit & ~tomb``, report a miss when
``tomb``, and fall back to the snapshot otherwise.

K3 returns the payload at the rank whether or not it hit, and 0 when the
query is above every key, as the TPU kernel does.  K1's plain version
(``fused_lookup.ops.lookup_plain``) uses :func:`overlay_probe_plain` for
its overlay merge and reads the payload only under ``hit & ~tomb``.

Dispatch is by the query tensor's device: a CPU tensor runs
:func:`overlay_probe_plain`, a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build


def overlay_probe_plain(ovr: dict, q: torch.Tensor):
    """Plain version of K3: (payload int64 bits, hit bool, tombstone bool).
    The reference's oracle counts keys < q with a (Q, cap) compare; the
    pack is sorted, so its lower bound (``searchsorted``) is that count."""
    pack = ovr["ov_pack"]
    keys = pack[0]
    cap = keys.shape[0]
    pos = torch.searchsorted(keys, q)
    in_pack = pos < cap
    posc = pos.clamp(max=cap - 1)
    hit = in_pack & (keys[posc] == q)
    return (torch.where(in_pack, pack[1][posc], 0), hit,
            hit & (pack[2][posc] != 0))


# threads an SM holds at once (H100: 2048; K3's 256-thread blocks of 17-20
# registers fit 8 an SM)
RESIDENT_THREADS = 2048


def k3_lanes(Q: int, sms: int) -> int:
    """K3's lanes a query for a batch of ``Q`` on ``sms`` SMs: the most, a
    power of two up to a warp, for which the batch's ``Q * lanes`` threads
    fit on the card at once, and 1 (a binary search) past that."""
    lanes = 32
    while lanes > 1 and Q * lanes > sms * RESIDENT_THREADS:
        lanes //= 2
    return lanes


def lower_bound_rounds(cap: int, lanes: int = 32) -> int:
    """Dependent rounds of K3's (lanes + 1)-way search over ``cap`` slots
    (``group_lower_bound``, its longest path): floor(log_{lanes+1}(cap)) +
    1, 5 at 2^24 for a warp.  A query's round trips are these, its key
    before them and the record at its rank after (counted from the source,
    not measured)."""
    rounds = 0
    while cap > 0:
        cap //= lanes + 1
        rounds += 1
    return rounds


def k3_bytes(Q: int, hits: int) -> int:
    """Bytes a K3 launch must move on its data: a query's key in, the key
    and payload at its rank, payload, hit and tombstone out; the tombstone
    flag of each of the ``hits``."""
    return Q * (8 + 8 + 8 + 10) + hits * 8


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.overlay_probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int,        # pack, cap
                   ctypes.c_void_p, ctypes.c_int,        # queries, count
                   ctypes.c_void_p, ctypes.c_void_p,     # out pay, hit
                   ctypes.c_void_p,                      # out tomb
                   ctypes.c_int,                         # lanes a query
                   ctypes.c_void_p]                      # stream
    fn.restype = ctypes.c_int


def overlay_probe(ovr: dict, q: torch.Tensor):
    """Probe the overlay pack ``ovr["ov_pack"]`` for the biased int64
    queries ``q``.  Returns (payload int64 bits, hit bool, tombstone bool).

    CPU tensors run :func:`overlay_probe_plain`; CUDA tensors launch K3
    with :func:`k3_lanes` lanes a query (counted in
    ``overlay_probe.launches``)."""
    if q.device.type == "cpu":
        return overlay_probe_plain(ovr, q)
    if q.device.type != "cuda":
        raise ValueError(f"overlay_probe runs on cpu or cuda, not "
                         f"{q.device}")
    pack = ovr["ov_pack"]
    dev = q.device
    if q.dtype != torch.int64 or q.dim() != 1 or not q.is_contiguous():
        raise ValueError("queries must be a contiguous 1-D biased int64 "
                         "tensor")
    if pack.device != dev or pack.dtype != torch.int64 or pack.dim() != 2 \
            or pack.shape[0] != 3 or pack.shape[1] < 1 \
            or not pack.is_contiguous():
        raise ValueError(f"overlay pack must be a contiguous (3, cap) int64 "
                         f"tensor on {dev}")
    lib = _build.load("overlay_probe", _bind)
    Q = q.shape[0]
    pay = torch.empty(Q, dtype=torch.int64, device=dev)
    hit = torch.empty(Q, dtype=torch.bool, device=dev)
    tomb = torch.empty(Q, dtype=torch.bool, device=dev)
    if Q == 0:
        return pay, hit, tomb
    stream = torch.cuda.current_stream(dev).cuda_stream
    lanes = k3_lanes(Q, torch.cuda.get_device_properties(dev)
                     .multi_processor_count)
    err = lib.overlay_probe_launch(pack.data_ptr(), pack.shape[1],
                                   q.data_ptr(), Q, pay.data_ptr(),
                                   hit.data_ptr(), tomb.data_ptr(), lanes,
                                   stream)
    _build.check(err, "overlay_probe")
    overlay_probe.launches += 1
    return pay, hit, tomb


overlay_probe.launches = 0
