"""The counts behind K3's and K5's bounds, on the CPU: the rounds of the
(lanes + 1)-way search K3 runs (``device_common.cuh``'s
``group_lower_bound``, simulated here lane by lane), the lanes a query K3
takes at each batch size (``overlay_probe.ops.k3_lanes``) and K5's walk
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
