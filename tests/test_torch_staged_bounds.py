"""The counts behind K3's, K4's and K5's bounds, on the CPU: the rounds of
the (lanes + 1)-way search K3 and K4 run (``device_common.cuh``'s
``group_lower_bound``, simulated here lane by lane), the lanes a query K3
takes at each batch size (``overlay_probe.ops.k3_lanes``) and K4 at each
width and batch size (``leaf_search.ops.k4_lanes``), K4's in-row search
against its plain version and its walk (``k4_walk``), sectors
(``k4_least_sectors``, ``k4_bytes``) against a hand count, and K5's walk
(``inner_probe.ops.probe_walk``) against a scalar walk written as the
kernel's thread runs it.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Aulid, AulidConfig, BlockDevice
from repro_torch.core import lookup as port
from repro_torch.core.device_index import build_device_index
from repro_torch.core.keys import key_f64, keys_to_tensor
from repro_torch.core.workloads import make_dataset, payloads_for
from repro_torch.kernels.inner_probe import ops as k5
from repro_torch.kernels.leaf_search import ops as k4
from repro_torch.kernels.overlay_probe import ops as k3

GEOM_512B = dict(block_bytes=512, leaf_capacity=32, mixed_slots_per_block=16,
                 pa_classes=(4, 8, 16), bt_max_children=4,
                 bt_child_capacity=7)
# around the search's part sizes: 33, 33^2 = 1089, 33^3 = 35937
CAPS = [1, 2, 32, 33, 34, 1088, 1089, 1090, 35937, 35938, 1 << 24]


def _group_lower_bound(ok: np.ndarray, q: int, lanes: int):
    """``group_lower_bound`` a lane at a time: (count(ok < q), rounds)."""
    lo, n, rounds = 0, ok.shape[0], 0
    while n > 0:
        step = n // (lanes + 1) + 1
        j = (np.arange(lanes) + 1) * step - 1
        below = (j < n) & (ok[lo + np.minimum(j, n - 1)] < q)
        c = int(below.sum())
        assert below[:c].all()          # the ballot is a prefix
        lo += c * step
        n = min(step - 1, n - c * step)
        rounds += 1
    return lo, rounds


@pytest.mark.parametrize("lanes", [32, 4, 1])
@pytest.mark.parametrize("cap", CAPS)
def test_warp_search_rounds(cap, lanes):
    rng = np.random.default_rng(cap)
    live = min(cap, 5000)
    ok = np.full(cap, np.iinfo(np.int64).max, np.int64)
    ok[:live] = np.sort(rng.choice(2**40, live, replace=False))
    qs = np.concatenate([[-2**63, np.iinfo(np.int64).max], ok[:live:97],
                         ok[:live:89] + 1, rng.integers(0, 2**40, 64)])
    most = k3.lower_bound_rounds(cap, lanes)
    seen = []
    for q in qs:
        pos, rounds = _group_lower_bound(ok, int(q), lanes)
        assert pos == np.searchsorted(ok, q, side="left")
        assert rounds <= most
        seen.append(rounds)
    assert max(seen) == most     # a query below every key takes them all
    assert most == int(np.floor(np.log(cap) / np.log(lanes + 1)
                                + 1e-9)) + 1


def test_k3_rounds_at_the_served_pack():
    assert k3.lower_bound_rounds(1 << 24) == 5
    assert [k3.lower_bound_rounds(1 << 24, g) for g in (16, 8, 4, 2, 1)] \
        == [6, 8, 11, 16, 25]
    assert k3.k3_bytes(8192, 100) == 8192 * 34 + 800


@pytest.mark.parametrize("sms", [132, 114, 1])
def test_k3_lanes_fill_the_card_once(sms):
    """A warp a query while the batch's warps fit on the card at once;
    past that the most lanes, a power of two, that still fit; 1 past
    ``sms * RESIDENT_THREADS`` queries."""
    room = sms * k3.RESIDENT_THREADS
    assert k3.k3_lanes(1, sms) == 32
    for Q in [1, 7, 256, 1024, 8192, 8193, 16384, 65536, room // 32,
              room // 32 + 1, room - 1, room, room + 1, 10 * room]:
        lanes = k3.k3_lanes(Q, sms)
        assert lanes in (32, 16, 8, 4, 2, 1)
        assert Q * lanes <= room or lanes == 1
        assert lanes == 32 or Q * lanes * 2 > room
    # the served batch gets a warp a query on an H100's 132 SMs; 65536
    # queries get 4 lanes
    assert k3.k3_lanes(8192, 132) == 32
    assert k3.k3_lanes(65536, 132) == 4


def _scalar_walk(key, succ, next_occ, s, q):
    """K5's thread: (kind is a slot's tag, records, hops)."""
    s = min(max(s, 0), key.shape[0] - 1)
    base = s // k5.SPB * k5.SPB
    cur = int(next_occ[s])
    records = hops = 0
    k = 0
    while base <= cur < base + k5.SPB:
        records += 1
        if k == k5.STALE_HOPS or not key[cur] < q:
            return True, records, hops
        cur = int(succ[cur])
        hops += 1
        k += 1
    return False, records, hops


@pytest.mark.parametrize("name", ["covid", "osm"])
def test_probe_walk_matches_the_kernel_walk(name):
    keys = make_dataset(name, 20_000, seed=1)
    idx = Aulid(BlockDevice(block_bytes=512), cfg=AulidConfig(**GEOM_512B))
    idx.bulkload(keys, payloads_for(keys))
    di = build_device_index(idx)
    arrs = port.device_arrays(di, "cpu")
    S = arrs["slot_tag"].shape[0]
    rng = np.random.default_rng(3)
    qn = np.resize(np.concatenate([rng.choice(keys, 3000),
                                   rng.integers(0, 2**64 - 1, 1000,
                                                dtype=np.uint64)]), S)
    q = keys_to_tensor(qn, "cpu")
    pi = k5.ProbeIndex(arrs, di.inner_height)
    key, succ, nxt = (arrs[f].numpy() for f in
                      ("slot_key", "succ_slot", "next_occ"))
    for slots in (torch.arange(S, dtype=torch.int32),
                  pi.predict(torch.zeros_like(q), key_f64(q)),
                  torch.tensor([-5, S, S + 200, 2**31 - 1] * 4,
                               dtype=torch.int32)):
        qq = q[:slots.shape[0]]
        records, hops, stop = k5.probe_walk(arrs, slots, qq)
        kind, _ = k5.probe_level_plain(arrs, slots, qq)
        exp = [_scalar_walk(key, succ, nxt, int(s), int(v))
               for s, v in zip(slots.tolist(), qq.tolist())]
        assert stop.tolist() == [int(e[0]) for e in exp]
        assert records.tolist() == [e[1] for e in exp]
        assert hops.tolist() == [e[2] for e in exp]
        assert torch.equal(stop.bool(), (kind != k5.KIND_END)
                           & (kind != k5.KIND_CONT))
        assert k5.k5_bytes(records, hops, stop) == \
            24 * slots.shape[0] + int(8 * records.clamp(max=3).sum()
                                      + 4 * hops.sum() + 8 * stop.sum())


# K4's row widths: PA rows (<= 64), the leaf row (256), BT rows (<= 1020),
# and around the search's part sizes (33, 33^2 = 1089)
K4_CAPS = [1, 2, 8, 32, 33, 64, 255, 256, 257, 1020, 1089]
UM = 2**64 - 1


def _k4_rows(rng, C: int) -> np.ndarray:
    """(6, C) sorted u64 rows: random distinct keys, a padded tail,
    duplicate runs (a BT row holds one key many times), the u64 extremes,
    all padding, and one key throughout."""
    rows = np.sort(rng.integers(1, UM - 1, (6, C), dtype=np.uint64), axis=1)
    rows[1, rng.integers(1, C + 1):] = UM
    runs = np.repeat(rng.integers(1, UM - 1, C, dtype=np.uint64),
                     rng.integers(1, 9, C))[:C]
    rows[2] = np.sort(np.resize(runs, C))
    rows[2, C - C // 4:] = UM
    rows[3] = np.sort(np.resize(np.array([0, 0, 1, 2**63 - 1, 2**63,
                                          UM - 1, UM - 1, UM],
                                         dtype=np.uint64), C))
    rows[4] = UM
    rows[5] = rows[0, C // 2]
    return rows


def _k4_case(C: int):
    rng = np.random.default_rng(C)
    keys = _k4_rows(rng, C)
    pay = rng.integers(0, UM, keys.shape, dtype=np.uint64)
    r = rng.integers(0, keys.shape[0], 300)
    q = keys[r, rng.integers(0, C, 300)]
    q[::3] += np.uint64(1)                       # just above a key
    q[1::7] = rng.integers(0, UM, q[1::7].shape[0], dtype=np.uint64)
    ext = np.array([0, 1, UM - 1, UM], dtype=np.uint64)
    # rows out of range, clamped by both
    r = np.concatenate([np.repeat(np.arange(keys.shape[0]), ext.size), r,
                        np.array([-3, 6, 2**31 - 1])]).astype(np.int32)
    q = np.concatenate([np.tile(ext, keys.shape[0]), q, ext[[1, 3, 0]]])
    kt = keys_to_tensor(keys.reshape(-1), "cpu").reshape(keys.shape)
    pt = torch.from_numpy(pay.view(np.int64).copy())
    return kt, pt, torch.from_numpy(r), keys_to_tensor(q, "cpu")


@pytest.mark.parametrize("lanes", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("C", K4_CAPS)
def test_k4_search_matches_plain(C, lanes):
    """The in-row search, lane by lane (``group_lower_bound`` over the
    query's clamped row, then the key and payload at the rank), equals
    ``leaf_search_plain``'s rank, found and payload; ``k4_walk`` gives the
    same rank and rounds, at most ``lower_bound_rounds(C, lanes)``."""
    kt, pt, rt, qt = _k4_case(C)
    exp_pay, exp_found = k4.leaf_search_plain(kt, pt, rt, qt)
    r = rt.long().clamp(0, kt.shape[0] - 1)
    exp_rank = (kt[r] < qt[:, None]).sum(1)
    rank, rounds, sectors = k4.k4_walk(kt, rt, qt, lanes)
    keys, pay = kt.numpy(), pt.numpy()
    most = k3.lower_bound_rounds(C, lanes)
    for i in range(qt.shape[0]):
        row, q = int(r[i]), int(qt[i])
        pos, n = _group_lower_bound(keys[row], q, lanes)
        assert pos == int(exp_rank[i]) == int(rank[i])
        assert n == int(rounds[i]) <= most
        found = pos < C and int(keys[row, pos]) == q
        assert found == bool(exp_found[i])
        assert (int(pay[row, pos]) if pos < C else 0) == int(exp_pay[i])
    # u64 max meets the padding: found, with the padding's payload
    assert bool(exp_found[4 * 4 + 3])
    assert int(rounds.max()) == most
    # the key at a rank below C lies in a sector the search already read
    at = (r * C + rank)[rank < C]
    assert bool(torch.isin((kt.data_ptr() + 8 * at) // k4.SECTOR,
                           sectors).all())


@pytest.mark.parametrize("sms", [132, 1])
def test_k4_lanes_by_width_and_batch(sms):
    """``MAX_LANES`` lanes, no more than a power of two that covers the
    row, halved while the batch's threads pass ``THREADS_PER_SM`` an SM;
    1 from ``sms * THREADS_PER_SM`` queries."""
    room = sms * k4.THREADS_PER_SM
    for C in [1, 2, 3, 8, 9, 32, 64, 65, 255, 256, 257, 1020, 1089]:
        cover = min(k4.MAX_LANES, 1 << (C - 1).bit_length())
        assert k4.k4_lanes(C, 1, sms) == cover
        for Q in [1, 33, 256, 2112, 2113, 8192, 8193, 65536, room // cover,
                  room // cover + 1, room, room + 1, 10 * room]:
            lanes = k4.k4_lanes(C, Q, sms)
            assert lanes in (16, 8, 4, 2, 1) and lanes <= cover
            assert Q * lanes <= room or lanes == 1
            assert lanes == cover or Q * lanes * 2 > room
    # the staged read's searches on an H100's 132 SMs: 4 lanes for its
    # 8192 leaf queries, 16 to 2,112 queries, 1 past 16,896
    if sms == 132:
        assert [k4.k4_lanes(256, Q, sms) for Q in
                (256, 2112, 2113, 4224, 8192, 8448, 16896, 16897)] == \
            [16, 16, 8, 8, 4, 4, 2, 1]
        assert [k4.k4_lanes(C, 8192, sms) for C in (1, 2, 64, 1020)] == \
            [1, 2, 4, 4]


@pytest.mark.parametrize("lanes, sectors",
                         [(16, 19), (32, 33), (8, 14), (1, 6)])
def test_k4_bytes_hand_count(lanes, sectors):
    """One C = 256 row of keys 0..255, q = 100: the sectors (4 keys each)
    the search touches, counted by hand.  16 lanes: splitters 15, 31, ...,
    255 (16 sectors), then keys 96..110 (sectors 24-27, 27 already read):
    19.  32 lanes: splitters 7, 15, ..., 255 (32 odd sectors), then 96..102
    (sectors 24, 25; 25 already read): 33.  8 lanes: splitters 28, 57, ...,
    231 (8 sectors), then 90, 94, ..., 114 in the part 87..114 (sectors
    22-28, 28 already read: 6 new), then 99..101 (sectors 24, 25, read):
    14, in 3 rounds.  1 lane: keys 128, 64, 96, 112, 104, 100, 98, 99
    (sectors 32, 16, 24, 28, 26, 25, 24, 24): 6, in 8 rounds.  The key at
    the rank, 100, lies in sector 25 each time."""
    keys = torch.arange(256, dtype=torch.int64)[None, :].clone()
    assert keys.data_ptr() % k4.SECTOR == 0
    q = torch.tensor([100])
    rank, rounds, sec = k4.k4_walk(keys, torch.zeros(1, dtype=torch.int32),
                                   q, lanes)
    assert int(rank[0]) == 100
    # its rounds: the longest path's at 8-32 lanes, one under it at 1
    assert int(rounds[0]) == {1: 8, 8: 3, 16: 2, 32: 2}[lanes] \
        <= k3.lower_bound_rounds(256, lanes)
    assert sec.numel() == sectors
    assert k4.k4_bytes(1, sectors, 1) == 21 + 32 * sectors + 8
    assert k4.k4_row_bytes(1, 1, 256) == 2048 + 29
    # the whole row's 64 sectors bound every walk
    assert sec.numel() <= 256 * 8 // k4.SECTOR


def test_k4_least_sectors_whatever_the_plan():
    """The search bound's sectors are the fewest any lanes a query touch,
    not the plan's: on the hand-counted row, 6 at 1 lane (16 lanes: 19);
    on the leaf-width case rows, no walk at 1-32 lanes touches fewer."""
    keys = torch.arange(256, dtype=torch.int64)[None, :].clone()
    assert k4.k4_least_sectors(keys, torch.zeros(1, dtype=torch.int32),
                               torch.tensor([100])) == (6, 1)
    kt, _, rt, qt = _k4_case(256)
    least, lanes = k4.k4_least_sectors(kt, rt, qt)
    walks = [int(k4.k4_walk(kt, rt, qt, g)[2].numel())
             for g in (1, 2, 4, 8, 16, 32)]
    assert least == min(walks) == walks[(1, 2, 4, 8, 16, 32).index(lanes)]
    assert least <= int(k4.k4_walk(kt, rt, qt, k4.k4_lanes(
        256, qt.shape[0], 132))[2].numel())


def test_k4_trips_from_the_source():
    assert [k4.k4_trips(256, g) for g in (32, 16, 8, 4, 1)] == \
        [4, 4, 5, 6, 11]
    assert [k4.k4_trips(64, g) for g in (32, 16, 8)] == [4, 4, 4]
    assert [k4.k4_trips(1020, g) for g in (32, 16, 8)] == [4, 5, 6]
