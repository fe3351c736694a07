"""K5 ``inner_probe``: one inner-level resolve inside a 128-slot block, in
``csrc/inner_probe.cu``, its plain PyTorch version, and the staged
block-at-a-time read built from it (:func:`inner_probe_lookup`).

Port of ``src/repro/kernels/inner_probe/inner_probe.py`` (the kernel),
``ref.py`` (its oracle) and ``ops.py`` (``ProbeIndex`` and the host
loop).  The loop is the paper's literal traversal (§4.2.1), batched: per
round the FMCD slot prediction (f64, outside the kernel), one K5 launch
that fetches the predicted slot's block and walks the stale chain, K4
``leaf_search`` over the PA/BT rows met, and a final K4 launch over the
leaf rows.  ``overlay_probe`` (K3) gives the overlay's verdict beside it.

The kernel reads the mirror's flat slot pools (``core.lookup``'s dict):
the TPU's (NB, 128) blocked copies are not built, because the block is
only the bound ``[s // 128 * 128, +128)`` and slots come from predictions
(< S), ``next_occ`` or ``succ_slot``, so their padding is never read.

Dispatch is by the query tensor's device: a CPU tensor runs
:func:`probe_level_plain`, a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.keys import key_f64
from .. import _build
from ..fused_lookup.ops import POOL_DTYPES, TAG_BT, TAG_DATA, TAG_MIXED, TAG_PA
from ..leaf_search.ops import leaf_search

SPB = 128        # slots per inner block
STALE_HOPS = 3   # stale-chain hops per probe (the mirror's bound)
KIND_CONT = 7    # the walk left the block: continue at val next round
KIND_END = 6     # the chain ended: resolve to the last leaf row
# the slot pools K5 reads, in kernel argument order
_SLOT_POOLS = ("slot_tag", "slot_key", "slot_ptr", "succ_slot", "next_occ")


# ------------------------------------------------------------ plain version
def probe_level_plain(arrs: dict, slots: torch.Tensor, q: torch.Tensor):
    """Plain version of K5, the vectorised twin of ``probe_level_ref``:
    (kind int32, val int32) per query.  Slots are clamped into range."""
    key, succ = arrs["slot_key"], arrs["succ_slot"]
    s = slots.long().clamp(0, key.shape[0] - 1)
    base = s // SPB * SPB
    cur = arrs["next_occ"][s].long()

    def in_block(c):
        return (c >= base) & (c < base + SPB)

    for _ in range(STALE_HOPS):
        inb = in_block(cur)
        lc = torch.where(inb, cur, 0)
        cur = torch.where(inb & (key[lc] < q), succ[lc].long(), cur)
    inb = in_block(cur)
    lc = torch.where(inb, cur, 0)
    kind = torch.where(cur < 0, KIND_END,
                       torch.where(inb, arrs["slot_tag"][lc].long(),
                                   KIND_CONT))
    val = torch.where(inb, arrs["slot_ptr"][lc].long(), cur)
    return kind.to(torch.int32), val.to(torch.int32)


def probe_walk(arrs: dict, slots: torch.Tensor, q: torch.Tensor):
    """What K5's walk visits for each query, from the plain walk: (records:
    in-block slot records reached, 0-4; hops: stale hops taken, 0-3; stop:
    whether the walk stopped on an in-block slot, whose tag and pointer it
    emits), each int64 per query."""
    key, succ = arrs["slot_key"], arrs["succ_slot"]
    s = slots.long().clamp(0, key.shape[0] - 1)
    base = s // SPB * SPB
    cur = arrs["next_occ"][s].long()
    records = torch.zeros_like(cur)
    hops = torch.zeros_like(cur)
    stop = torch.zeros_like(cur)
    walking = torch.ones_like(cur, dtype=torch.bool)
    for k in range(STALE_HOPS + 1):
        inb = walking & (cur >= base) & (cur < base + SPB)
        records += inb
        if k == STALE_HOPS:
            stop += inb
            break
        lc = torch.where(inb, cur, 0)
        walking = inb & (key[lc] < q)
        stop += inb & ~walking
        hops += walking
        cur = torch.where(walking, succ[lc].long(), cur)
    return records, hops, stop


def k5_bytes(records, hops, stop) -> int:
    """Bytes a K5 launch must move on its data (:func:`probe_walk`): a
    query's slot and key in, ``next_occ``, kind and val out; a key for each
    compare (at most 3), a successor for each hop, tag and pointer where
    the walk stops in the block."""
    return int(records.numel() * (4 + 8 + 4 + 8)
               + 8 * records.clamp(max=STALE_HOPS).sum() + 4 * hops.sum()
               + 8 * stop.sum())


# ------------------------------------------------------------------ wrapper
def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.inner_probe_launch
    fn.argtypes = ([ctypes.c_void_p] * len(_SLOT_POOLS)
                   + [ctypes.c_int,                      # slot count
                      ctypes.c_void_p, ctypes.c_void_p,  # slots, queries
                      ctypes.c_int,                      # query count
                      ctypes.c_void_p, ctypes.c_void_p,  # out kind, val
                      ctypes.c_void_p])                  # stream
    fn.restype = ctypes.c_int


def _check(arrs: dict, slots: torch.Tensor, q: torch.Tensor) -> None:
    dev = q.device
    if q.dtype != torch.int64 or q.dim() != 1 or not q.is_contiguous():
        raise ValueError("queries must be a contiguous 1-D biased int64 "
                         "tensor")
    if slots.device != dev or slots.dtype != torch.int32 \
            or slots.shape != q.shape or not slots.is_contiguous():
        raise ValueError(f"slots must be a contiguous int32 tensor of "
                         f"{tuple(q.shape)} on {dev}")
    n = arrs["slot_tag"].shape[0]
    for f in _SLOT_POOLS:
        t = arrs[f]
        if t.device != dev or t.dtype != POOL_DTYPES[f] or t.dim() != 1 \
                or t.shape[0] != n or n < 1 or not t.is_contiguous():
            raise ValueError(f"slot pool {f!r}: want a contiguous (S>=1,) "
                             f"{POOL_DTYPES[f]} tensor on {dev}")


def probe_level(arrs: dict, slots: torch.Tensor, q: torch.Tensor):
    """One probe round: for each query, resolve global slot ``slots[i]``
    of the mirror ``arrs`` inside its 128-slot block.  Returns (kind int32:
    the slot tag, ``KIND_CONT`` or ``KIND_END``; val int32: the slot's ptr
    or the slot reached).

    CPU tensors run :func:`probe_level_plain`; CUDA tensors launch K5
    (counted in ``probe_level.launches``)."""
    if q.device.type == "cpu":
        return probe_level_plain(arrs, slots, q)
    if q.device.type != "cuda":
        raise ValueError(f"probe_level runs on cpu or cuda, not {q.device}")
    _check(arrs, slots, q)
    lib = _build.load("inner_probe", _bind)
    Q = q.shape[0]
    kind = torch.empty(Q, dtype=torch.int32, device=q.device)
    val = torch.empty(Q, dtype=torch.int32, device=q.device)
    if Q == 0:
        return kind, val
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.inner_probe_launch(*[arrs[f].data_ptr() for f in _SLOT_POOLS],
                                 arrs["slot_tag"].shape[0], slots.data_ptr(),
                                 q.data_ptr(), Q, kind.data_ptr(),
                                 val.data_ptr(), stream)
    _build.check(err, "inner_probe")
    probe_level.launches += 1
    return kind, val


probe_level.launches = 0


# --------------------------------------------------------- the staged read
class ProbeIndex:
    """The staged read's view of a mirror dict (``core.lookup``'s
    ``mirror_from_numpy`` / ``device_arrays``): its pools are used as they
    are — the leaf pool is the mirror's own tensor — and only the small
    PA/BT ptr pools are widened to int64, so one K4 signature serves PA/BT
    rows (payload = leaf row) and leaf rows."""

    def __init__(self, arrs: dict, inner_height: int):
        self.arrs = arrs
        self.inner_height = int(inner_height)
        self.root_node, self.last_leaf_row = arrs["meta"].tolist()
        self.pa_pay = arrs["pa_ptrs"].to(torch.int64)
        self.bt_pay = arrs["bt_ptrs"].to(torch.int64)

    def predict(self, node: torch.Tensor, qf: torch.Tensor) -> torch.Tensor:
        """f64 FMCD slot prediction with the mirror's safety margin:
        ``node_base + clip(floor(slope * q + intercept) - 1, 0, fanout-1)``
        (int32); ``qf`` is the queries' exact f64 value."""
        a = self.arrs
        pred = torch.floor(a["node_slope"][node] * qf
                           + a["node_intercept"][node]) - 1
        hi = (a["node_fanout"][node] - 1).to(torch.float64)
        pred = torch.minimum(pred.clamp(min=0.0), hi).long()
        return (a["node_base"][node].long() + pred).to(torch.int32)


def inner_probe_lookup(pi: ProbeIndex, q: torch.Tensor, *,
                       count_rounds: bool = False, trace: list | None = None):
    """Batched point read of the biased int64 queries ``q`` by rounds of
    block fetches, the reference's ``inner_probe_lookup``.  Returns
    (payload int64 bits at the leaf rank, found bool[, rounds]); ``rounds``
    counts the K5 rounds plus one per PA/BT round that met a row, plus the
    leaf fetch.  The snapshot only: merge ``overlay_probe`` for the
    overlay.

    With ``trace`` (a list), every kernel call of the read is appended to it
    as (wrapper name, inputs, outputs), so a run can be held against the
    plain versions on exactly the tensors it launched on."""
    def call(fn, *args):
        out = fn(*args)
        if trace is not None:
            trace.append((fn.__name__, args, out))
        return out

    a = pi.arrs
    Q = q.shape[0]
    last = pi.last_leaf_row
    done = q >= a["last_leaf_min"]
    if pi.root_node < 0:
        done = torch.ones_like(done)
    leaf = torch.where(done, last, -1)
    node = torch.zeros(Q, dtype=torch.int64, device=q.device)
    qf = key_f64(q)
    slots = pi.predict(node, qf)
    rounds = 0
    max_rounds = 4 * max(pi.inner_height, 1) + 4
    while rounds < max_rounds and not bool(done.all()):
        rounds += 1
        act = ~done
        kind, val = call(probe_level, a, torch.where(act, slots, 0), q)
        is_end = act & (kind == KIND_END)
        is_data = act & (kind == TAG_DATA)
        leaf = torch.where(is_end, last, torch.where(is_data, val, leaf))
        done = done | is_end | is_data
        for tag, keys, pay in ((TAG_PA, a["pa_keys"], pi.pa_pay),
                               (TAG_BT, a["bt_keys"], pi.bt_pay)):
            idx = torch.nonzero(act & (kind == tag))[:, 0]
            if idx.numel():
                rows, _ = call(leaf_search, keys, pay, val[idx], q[idx])
                leaf[idx] = rows
                done[idx] = True
                rounds += 1  # the PA/BT block fetch
        is_mixed = act & (kind == TAG_MIXED)
        node = torch.where(is_mixed, val.long(), node)
        slots = torch.where(is_mixed, pi.predict(node, qf),
                            torch.where(act & (kind == KIND_CONT), val,
                                        slots))
    leaf = torch.where(leaf < 0, last, leaf).to(torch.int32)
    pay, found = call(leaf_search, a["leaf_keys"], a["leaf_pay"], leaf, q)
    if count_rounds:
        return pay, found, rounds + 1
    return pay, found
