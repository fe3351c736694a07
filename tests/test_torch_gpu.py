"""Card-only tests: each hand-written CUDA kernel == its plain PyTorch
version on the same tensors, exactly (K6 ``paged_attention`` within float
tolerances); the engine on the card == the engine on the CPU, request for
request; the staged read on the card == on the CPU; the LM ``ServeEngine``
on the card == on the CPU, token for token; the contiguous-cache steps of
every family and the train step on the card == on the CPU.

Every test here is marked ``gpu`` and skips without a CUDA device (the
kernels have no CPU mode).  This file imports only the port, so it runs
where the JAX reference is not installed:
``python -m pytest -m gpu tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Aulid, AulidConfig, BlockDevice, DeltaOverlay
from repro_torch.core import lookup as port
from repro_torch.core.device_index import build_device_index
from repro_torch.core.keys import (BIASED_MAX, key_f64, keys_from_tensor,
                                   keys_to_tensor)
from repro_torch.core.workloads import make_dataset, payloads_for
from repro_torch.kernels.fused_lookup import ops as k1
from repro_torch.kernels.inner_probe import ops as k5
from repro_torch.kernels.leaf_search import ops as k4
from repro_torch.kernels.overlay_merge import ops as k2
from repro_torch.kernels.overlay_probe import ops as k3
from repro_torch.kernels.paged_attention import ops as k6
from repro_torch.serving import IndexEngine

pytestmark = pytest.mark.gpu

GEOMS = {"4k": {}, "512b": dict(block_bytes=512, leaf_capacity=32,
                                mixed_slots_per_block=16,
                                pa_classes=(4, 8, 16), bt_max_children=4,
                                bt_child_capacity=7)}
CASES = [(d, g) for g in GEOMS for d in ("covid", "planet", "genome", "osm")]
UM = np.uint64(2**64 - 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _queries(keys, rng):
    edges = np.array([0, int(keys[0]), int(keys[-1]), int(keys[-1]) + 1,
                      2**63, 2**64 - 1], dtype=np.uint64)
    return np.concatenate([rng.choice(keys, 3000),
                           rng.integers(0, 2**64 - 1, 1000, dtype=np.uint64),
                           edges])


@pytest.mark.parametrize("name,geom", CASES,
                         ids=[f"{d}-{g}" for d, g in CASES])
def test_fused_lookup_kernel_matches_plain(cuda, name, geom):
    keys = make_dataset(name, 50_000, seed=1)
    idx = Aulid(BlockDevice(), cfg=AulidConfig(**GEOMS[geom]))
    idx.bulkload(keys, payloads_for(keys))
    di = build_device_index(idx)
    h = max(di.max_inner_height, 3)
    rng = np.random.default_rng(7)
    ov = DeltaOverlay()
    for k in rng.integers(0, 2**62, 200, dtype=np.uint64):
        ov.record_insert(int(k), int(k) % 1009)
    for k in rng.choice(keys, 100):
        ov.record_insert(int(k), 5)
    for k in rng.choice(keys, 100):
        ov.record_delete(int(k))
    arrs = port.device_arrays(di, cuda)
    q = keys_to_tensor(_queries(keys, rng), cuda)
    for ovr in (None, port.overlay_arrays(ov, cuda)):
        n = k1.fused_lookup.launches
        got = k1.fused_lookup(arrs, ovr, q, h)
        assert k1.fused_lookup.launches == n + 1
        exp = k1.lookup_plain(arrs, ovr, q, h)
        torch.cuda.synchronize()
        for g, e in zip(got, exp):
            assert torch.equal(g, e)
        assert got[1][:3000].any()


def test_fused_lookup_empty_mirror(cuda):
    arrs = port.device_arrays(build_device_index(Aulid()), cuda)
    q = keys_to_tensor(np.array([0, 5, 2**50, 2**64 - 1], np.uint64), cuda)
    got = k1.fused_lookup(arrs, None, q, 3)
    exp = k1.lookup_plain(arrs, None, q, 3)
    for g, e in zip(got, exp):
        assert torch.equal(g, e)


# ------------------------------------------ K1's overlay probe and staged rows
# pack capacities around the 33-way search's part sizes (33, 33^2 = 1089)
OV_CAPS = [1, 2, 32, 33, 34, 1089, 1090, 1 << 16]
OV_FILLS = ["few", "full", "padding"]
# row geometries: an odd leaf cap (8-byte copies; BT rows of 181 keys in
# slice-sized chunks), an even one not a multiple of 32, a mirror with no
# PA or BT node (caps of 1), PA rows longer than the 16-key slice
STAGE_GEOMS = {"leaf33": dict(leaf_capacity=33),
               "leaf34": dict(leaf_capacity=34),
               "no-pa": dict(lipp_inner=True),
               "leaf16": dict(leaf_capacity=16)}
# (live shards, slots): "flat" is the monolithic form; (6, 8) pads with
# placeholder shards whose bounds are UINT64_MAX
LAYOUTS = {"flat": None, "s1": (1, 0), "s2": (2, 0), "s6of8": (6, 8)}
_K1_CACHE: dict = {}


def _k1_case(cuda, geom, layout):
    """(keys, mirror or stack, height, sharded) of 50k ``osm`` keys, built
    once per (geometry, layout)."""
    from repro_torch.core import partition_bulkload
    from repro_torch.core.device_index import stack_device_indexes
    if (geom, layout) not in _K1_CACHE:
        keys = make_dataset("osm", 50_000, seed=1)
        cfg = AulidConfig(**{**GEOMS, **STAGE_GEOMS}[geom])
        if LAYOUTS[layout] is None:
            idx = Aulid(BlockDevice(block_bytes=cfg.block_bytes), cfg=cfg)
            idx.bulkload(keys, payloads_for(keys))
            di = build_device_index(idx)
            case = (keys, port.device_arrays(di, cuda),
                    max(di.max_inner_height, 3), False)
        else:
            live, slots = LAYOUTS[layout]
            part = partition_bulkload(keys, payloads_for(keys), live, cfg=cfg)
            sdi = stack_device_indexes(
                [build_device_index(sh) for sh in part.shards], part.bounds,
                min_shards=slots)
            case = (keys, port.stacked_device_arrays(sdi, device=cuda),
                    max(sdi.max_inner_height, 3), True)
        _K1_CACHE[(geom, layout)] = case
    return _K1_CACHE[(geom, layout)]


def _k1_same(cuda, mirror, sharded, ovr, q, h):
    """Both forms' launch == their plain version, bit for bit."""
    fn = k1.fused_lookup_sharded if sharded else k1.fused_lookup
    plain = k1.lookup_sharded_plain if sharded else k1.lookup_plain
    n = fn.launches
    got = fn(mirror, ovr, q, h)
    assert fn.launches == n + 1
    _same(got, plain(mirror, ovr, q, h))
    return got


def _ov_pack(rng, keys, cap, fill):
    """A sorted (3, cap) pack: ``few`` live entries, ``full`` (key 0 and
    2**64-2 among them) or all ``padding``; about half the live keys are
    the mirror's, a quarter of the entries tombstones."""
    n = {"few": min(3, cap), "full": cap, "padding": 0}[fill]
    edge = np.array([0, 2**64 - 2] if fill == "full" else [],
                    np.uint64)[:n]
    mine = np.setdiff1d(rng.choice(keys, n // 2, replace=False), edge)
    rand = np.setdiff1d(rng.integers(1, 2**64 - 2, 2 * n + 2,
                                     dtype=np.uint64),
                        np.concatenate([edge, mine]))
    live = np.concatenate([edge, mine, rng.permutation(rand)])[:n]
    return _pack(rng, live, cap)


@pytest.mark.parametrize("fill", OV_FILLS)
@pytest.mark.parametrize("cap", OV_CAPS)
def test_fused_lookup_overlay_probe_matches_plain(cuda, cap, fill):
    """K1's 33-way overlay search == the plain count(ok < q), both forms:
    queries at 0, at u64 max (the padding key) and at every pack key and
    its neighbours, over packs of few live entries, full and all
    padding."""
    rng = np.random.default_rng(cap)
    keys = _k1_case(cuda, "512b", "flat")[0]
    pack = _ov_pack(rng, keys, cap, fill)
    live = pack[0][pack[0] != UM]
    near = np.concatenate([live, live - np.uint64(1), live + np.uint64(1)])
    qn = np.concatenate([np.array([0, 1, 2**64 - 2, UM], np.uint64), near,
                         rng.choice(keys, 500),
                         rng.integers(0, UM, 200, dtype=np.uint64)])
    for layout in ("flat", "s2"):
        _, mirror, h, sharded = _k1_case(cuda, "512b", layout)
        q = keys_to_tensor(qn, cuda)
        ovr = port.overlay_from_numpy(pack, cuda)
        found = _k1_same(cuda, mirror, sharded, ovr, q, h)[1]
        # every live pack key hits: found unless a tombstone
        assert np.array_equal(found[4:4 + live.size].cpu().numpy(),
                              pack[2][:live.size] == 0)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("geom", list(STAGE_GEOMS))
def test_fused_lookup_staged_rows_match_plain(cuda, geom, layout):
    """K1's rows staged by cp.async == the plain version, both forms, with
    and without an overlay: odd leaf and BT caps (8-byte copies), even caps
    that are not a multiple of 32, PA and BT rows in several chunks, PA/BT
    caps of 1; the sharded form at 1, 2 and 8 shard slots (placeholders
    past the 6 live ones)."""
    keys, mirror, h, sharded = _k1_case(cuda, geom, layout)
    shape = (lambda f: mirror[f].shape[-1])
    plan = k1._stage_plan(shape("leaf_keys"), shape("pa_keys"),
                          shape("bt_keys"))
    for bit, f in ((k1.WIDE_LEAF, "leaf_keys"), (k1.WIDE_PA, "pa_keys"),
                   (k1.WIDE_BT, "bt_keys")):
        assert bool(plan.wide & bit) == (shape(f) % 2 == 0)
    if geom == "no-pa":
        assert shape("pa_keys") == shape("bt_keys") == 1
    rng = np.random.default_rng(len(geom))
    qn = _queries(keys, rng)
    if sharded:
        bounds = keys_from_tensor(mirror["bounds"]) if \
            mirror["bounds"].numel() else np.empty(0, np.uint64)
        qn = np.concatenate([qn] + [np.array(
            [b - 1, b, b + 1] if 0 < b < UM else [b], np.uint64)
            for b in bounds])
    q = keys_to_tensor(qn, cuda)
    ov = DeltaOverlay()
    for k in rng.integers(0, 2**62, 300, dtype=np.uint64):
        ov.record_insert(int(k), int(k) % 1009)
    for k in rng.choice(keys, 100):
        ov.record_delete(int(k))
    for ovr in (None, port.overlay_arrays(ov, cuda)):
        got = _k1_same(cuda, mirror, sharded, ovr, q, h)
        assert got[1][:3000].any()


def _pack(rng, keys, cap):
    keys = np.sort(np.asarray(keys, dtype=np.uint64))
    n = keys.shape[0]
    pack = np.zeros((3, cap), dtype=np.uint64)
    pack[0] = UM
    pack[0, :n] = keys
    pack[1, :n] = rng.integers(0, 2**63, n, dtype=np.uint64)
    pack[2, :n] = rng.random(n) < 0.25
    return pack


def _merge_cases():
    rng = np.random.default_rng(0)
    pool = rng.choice(2**60, size=40_000, replace=False).astype(np.uint64)
    yield "empty-pack", _pack(rng, [], 64), _pack(rng, pool[:40], 64), 64
    yield "empty-batch", _pack(rng, pool[:50], 64), _pack(rng, [], 8), 64
    yield "all-overlap", _pack(rng, pool[:512], 1024), \
        _pack(rng, pool[:512], 512), 1024
    yield "cap-growth", _pack(rng, pool[:1000], 1024), \
        _pack(rng, pool[900:1400], 512), 2048
    yield "multi-chunk-batch", _pack(rng, pool[:3000], 4096), \
        _pack(rng, pool[2000:5000], 4096), 8192
    yield "big-pack", _pack(rng, pool[:30_000], 1 << 20), \
        _pack(rng, pool[29_800:30_312], 512), 1 << 20
    # one thread owns the whole batch; a batch searched in global memory;
    # one whose flag scan takes more than 48 KB of shared memory
    yield "empty-pack-big-batch", _pack(rng, [], 64), \
        _pack(rng, pool[:4000], 4096), 4096
    yield "global-batch", _pack(rng, pool[:9000], 16384), \
        _pack(rng, pool[8000:16000], 8192), 32768
    big = np.random.default_rng(1).choice(2**60, size=210_000,
                                          replace=False).astype(np.uint64)
    yield "scan-past-48k", _pack(rng, big[:1000], 1 << 18), \
        _pack(rng, big[500:200_500], 1 << 18), 1 << 18


MERGE_CASES = list(_merge_cases())


@pytest.mark.parametrize("name,a,b,cap_out", MERGE_CASES,
                         ids=[c[0] for c in MERGE_CASES])
def test_overlay_merge_kernel_matches_plain(cuda, name, a, b, cap_out):
    pa = port.overlay_from_numpy(a, cuda)["ov_pack"]
    pb = port.overlay_from_numpy(b, cuda)["ov_pack"]
    n = k2.overlay_merge.launches
    got = k2.overlay_merge(pa, pb, cap_out)
    assert k2.overlay_merge.launches == n + 1
    exp = k2.merge_overlay_pack_torch(pa, pb, cap_out)
    torch.cuda.synchronize()
    assert torch.equal(got, exp)


SENTINEL = 12345


def _target(rng, cap, fill, dev):
    """A target that holds garbage in [0, fill) and, past it, a sentinel
    that is not padding: whatever the kernel writes past max(n_out, fill)
    shows."""
    t = torch.full((3, cap), SENTINEL, dtype=torch.int64)
    f = min(fill, cap)
    t[:, :f] = torch.from_numpy(rng.integers(-9, 9, (3, f)))
    return t.to(dev)


@pytest.mark.parametrize("name,a,b,cap_out", MERGE_CASES,
                         ids=[c[0] for c in MERGE_CASES])
def test_overlay_merge_into_kernel_matches_plain(cuda, name, a, b, cap_out):
    """K2 into a target == ``merge_overlay_into_torch`` on a copy of it,
    fills equal, for targets filled below, past and at the merged count
    (a fresh one: fill = cap) and pack fill bounds exact and loose; the
    sentinel past max(n_out, fill) survives."""
    rng = np.random.default_rng(cap_out)
    pa = port.overlay_from_numpy(a, cuda)["ov_pack"]
    pb = port.overlay_from_numpy(b, cuda)["ov_pack"]
    fresh = k2.merge_overlay_pack_torch(pa, pb, cap_out)
    n_out = int((fresh[0] != BIASED_MAX).sum())
    live = int((pa[0] != BIASED_MAX).sum())
    for f_t in sorted({0, max(n_out - 7, 0), n_out, n_out + 33, cap_out}):
        for fill in (live, a.shape[1]):
            tgt = _target(rng, cap_out, f_t, cuda)
            exp_t = tgt.clone()
            n = k2.overlay_merge.launches
            got = k2.overlay_merge(pa, pb, cap_out, out=tgt, fill=fill,
                                   out_fill=f_t)
            assert k2.overlay_merge.launches == n + 1
            exp = k2.merge_overlay_into_torch(pa, pb, cap_out, exp_t, f_t,
                                              fill)
            torch.cuda.synchronize()
            assert torch.equal(tgt, exp_t), (f_t, fill)
            assert int(got) == int(exp) == n_out
            hi = max(n_out, min(f_t, cap_out))
            assert torch.equal(tgt[:, :hi], fresh[:, :hi])
            assert bool((tgt[:, hi:] == SENTINEL).all())


def test_overlay_merge_stacked_into_kernel_matches_plain(cuda):
    """K2's stacked form into a target with a fill a row (garbage below
    it, the sentinel past it) == its plain version, fills equal; the
    sentinel past each row's max(n_out, fill) survives."""
    rng = np.random.default_rng(18)
    pool = rng.choice(2**60, size=40_000, replace=False).astype(np.uint64)
    rows = [(_pack(rng, [], 4096), _pack(rng, pool[:300], 512)),
            (_pack(rng, pool[:512], 4096), _pack(rng, pool[:512], 512)),
            (_pack(rng, pool[:3000], 4096), _pack(rng, pool[2900:3300], 512)),
            (_pack(rng, pool[:100], 4096), _pack(rng, [], 512)),
            (_pack(rng, pool[5000:5020], 4096), _pack(rng, pool[:512], 512))]
    pa = torch.stack([port.overlay_from_numpy(a, cuda)["ov_pack"]
                      for a, _ in rows])
    pb = torch.stack([port.overlay_from_numpy(b, cuda)["ov_pack"]
                      for _, b in rows])
    fresh = k2.merge_overlay_stacked_torch(pa, pb, 4096)
    n_out = (fresh[:, 0] != BIASED_MAX).sum(1).tolist()
    fills = [0, n_out[1] + 100, max(n_out[2] - 50, 0), 4096, n_out[4]]
    live = (pa[:, 0] != BIASED_MAX).sum(1).tolist()
    tgt = torch.stack([_target(rng, 4096, f, cuda) for f in fills])
    exp_t = tgt.clone()
    n = k2.overlay_merge_stacked.launches
    got = k2.overlay_merge_stacked(pa, pb, 4096, out=tgt, fill=live,
                                   out_fill=fills)
    assert k2.overlay_merge_stacked.launches == n + 1
    exp = k2.merge_overlay_stacked_into_torch(pa, pb, 4096, exp_t, fills,
                                              live)
    torch.cuda.synchronize()
    assert torch.equal(tgt, exp_t)
    assert got.tolist() == exp.tolist() == n_out
    for s, f in enumerate(fills):
        hi = max(n_out[s], f)
        assert torch.equal(tgt[s, :, :hi], fresh[s, :, :hi]), s
        assert bool((tgt[s, :, hi:] == SENTINEL).all()), s
    # one fill for every row
    tgt = torch.stack([_target(rng, 4096, 700, cuda) for _ in rows])
    exp_t = tgt.clone()
    got = k2.overlay_merge_stacked(pa, pb, 4096, out=tgt, out_fill=700)
    exp = k2.merge_overlay_stacked_into_torch(pa, pb, 4096, exp_t, 700)
    torch.cuda.synchronize()
    assert torch.equal(tgt, exp_t) and got.tolist() == exp.tolist()


def test_engine_steps_serve_from_two_buffers(cuda):
    """Consecutive merge steps of ``IndexEngine`` on the card serve from
    two alternating buffers (the merge writes into the spare), and the
    served pack equals the CPU engine's after every step."""
    keys = make_dataset("covid", 3_000, seed=2)
    rng = np.random.default_rng(6)
    engines = []
    for device in ("cpu", cuda):
        idx = Aulid(BlockDevice(), cfg=AulidConfig(**GEOMS["512b"]))
        idx.bulkload(keys, payloads_for(keys))
        engines.append(IndexEngine(idx, device=device, gamma=0.5))
    ptrs = []
    for _ in range(5):
        fresh = rng.integers(1, 2**60, 30, dtype=np.uint64)
        step = ([("insert", int(k), int(k) % 13) for k in fresh]
                + [("delete", int(k)) for k in rng.choice(keys, 5)]
                + [("get", int(k)) for k in fresh[:5]])
        outs = []
        for eng in engines:
            reqs = [eng.submit(*r) for r in step]
            eng.step()
            outs.append([r.result for r in reqs])
        assert outs[0] == outs[1]
        assert torch.equal(engines[1].ov_arrs["ov_pack"].cpu(),
                           engines[0].ov_arrs["ov_pack"])
        ptrs.append(engines[1].ov_arrs["ov_pack"].data_ptr())
    # the first merge takes a fresh target; from then on two buffers
    assert ptrs[0] == ptrs[2] == ptrs[4] != ptrs[1] == ptrs[3]
    assert engines[1].stats()["overlay_merges"] == 5


def _drive(eng, trace):
    out = []
    for step in trace:
        reqs = [eng.submit(*args) for args in step]
        eng.step()
        if eng._inflight is not None:
            # let the background build finish, so that every engine installs
            # it at the next step boundary whatever its thread's speed
            eng._inflight.result()
        out.extend((r.op, r.key, tuple(r.result) if isinstance(r.result, list)
                    else r.result) for r in reqs)
    return out


@pytest.mark.parametrize("async_compact", [False, True],
                         ids=["sync", "async"])
def test_engine_on_card_matches_cpu(cuda, async_compact):
    keys = make_dataset("osm", 4_000, seed=1)
    rng = np.random.default_rng(3)
    trace = []
    for _ in range(8):
        fresh = rng.integers(1, 2**60, 40, dtype=np.uint64)
        trace.append([("insert", int(k), int(k) % 91) for k in fresh]
                     + [("delete", int(k)) for k in rng.choice(keys, 10)]
                     + [("get", int(k)) for k in rng.choice(keys, 60)]
                     + [("get", int(k)) for k in fresh[:10]]
                     + [("scan", int(k), 0, 50) for k in rng.choice(keys, 4)])
    engines = []
    for device in ("cpu", cuda):
        idx = Aulid(BlockDevice(), cfg=AulidConfig(**GEOMS["512b"]))
        idx.bulkload(keys, payloads_for(keys))
        engines.append(IndexEngine(idx, device=device, gamma=0.02,
                                   async_compact=async_compact))
    n1, n2 = k1.fused_lookup.launches, k2.overlay_merge.launches
    out = [_drive(e, trace) for e in engines]
    for e in engines:
        e.drain_compactions()
    assert out[0] == out[1]
    assert k1.fused_lookup.launches > n1 and k2.overlay_merge.launches > n2
    st = [e.stats() for e in engines]
    assert st[1]["read_backend"] == "cuda"
    assert st[0]["compactions"] == st[1]["compactions"] >= 1


def test_engine_on_card_scans_of_100_match_cpu(cuda):
    """A step of 8,192 scans of 100 on the card (the benchmark's w2 step)
    over a bulkloaded index with a live overlay and writes of the same
    step: each answer is a ``ScanRows`` owning its rows, equal to the CPU
    engine's and to the host index's list (``Aulid.scan``).  The JAX
    reference's lists are held to the CPU engine at this shape in
    ``test_torch_scan_rows.py``."""
    from repro_torch.serving import ScanRows
    keys = make_dataset("covid", 200_000, seed=1)
    rng = np.random.default_rng(5)
    before = ([("insert", int(k), int(k) % 89)
               for k in rng.integers(1, 2**60, 300, dtype=np.uint64)]
              + [("delete", int(k)) for k in rng.choice(keys, 100)])
    step = ([("insert", int(k), int(k) % 97)
             for k in rng.integers(1, 2**60, 300, dtype=np.uint64)]
            + [("delete", int(k)) for k in rng.choice(keys, 100)]
            + [("scan", int(k), 0, 100) for k in rng.choice(keys, 8192)])
    engines, outs = [], []
    for device in ("cpu", cuda):
        idx = Aulid(BlockDevice())
        idx.bulkload(keys, payloads_for(keys))
        eng = IndexEngine(idx, device=device, gamma=0.5)
        for s in (before, step):
            reqs = [eng.submit(*a) for a in s]
            eng.step()
        engines.append(eng)
        outs.append([r.result for r in reqs if r.op == "scan"])
    assert engines[1].stats()["read_backend"] == "cuda"
    assert engines[1]._overlay_live() > 0
    assert len(outs[1]) == 8192
    host = engines[0].idx
    for (_, key, _, count), cpu_rows, card_rows in zip(step[400:], *outs):
        assert isinstance(card_rows, ScanRows) and len(card_rows) == count
        assert card_rows.keys.base is None and card_rows.payloads.base is None
        assert card_rows == cpu_rows
        assert card_rows == host.scan(key, count)


def _same(got, exp):
    torch.cuda.synchronize()
    for g, e in zip(got, exp):
        assert torch.equal(g, e)


# ------------------------------------------------------------- the mesh
MESH_DEVICES = (1, 2, 4)


@pytest.mark.parametrize("D", MESH_DEVICES)
def test_fused_lookup_mesh_matches_plain(cuda, D):
    """K1 once a position over a stack placed on a mesh naming cuda:0 D
    times == the same mesh read on the CPU (the plain version) and == the
    one-device shard route: found and payload where the query is real
    (the sentinel, 2**64 - 1, is owned by no position and reads zeros),
    leaf rows where found, shard ids where real; the mesh scans alike
    where valid."""
    from repro_torch.parallel import index_mesh, place_stacked
    keys, stk, h, _ = _k1_case(cuda, "512b", "s6of8")     # 8 slots
    rng = np.random.default_rng(D)
    qn = np.sort(_queries(keys, rng))
    q = keys_to_tensor(qn, cuda)
    real = torch.from_numpy(qn != UM).to(cuda)
    mesh = index_mesh(D, devices=[cuda] * D)
    placed = place_stacked(stk, mesh)
    assert placed["leaf_keys"][0].data_ptr() == stk["leaf_keys"].data_ptr()
    cpu_placed = place_stacked({f: v.cpu() if torch.is_tensor(v) else v
                                for f, v in stk.items()},
                               index_mesh(D, devices=["cpu"] * D))
    one = k1.fused_lookup_sharded(stk, None, q, h)
    for qcap in (None, 600, len(qn)):
        n = k1.fused_lookup_sharded_mesh.launches
        got = k1.fused_lookup_sharded_mesh(mesh, placed, q, h, qcap)
        assert k1.fused_lookup_sharded_mesh.launches == n + D
        plain = k1.fused_lookup_sharded_mesh(
            index_mesh(D, devices=["cpu"] * D), cpu_placed, q.cpu(), h, qcap)
        _same(got, [t.to(cuda) for t in plain])
        if qcap == 600:
            continue            # a window below some position's load
        assert torch.equal(got[0][real], one[0][real])
        assert torch.equal(got[1][real], one[1][real])
        assert not got[1][~real].any() and not got[0][~real].any()
        assert torch.equal(got[2][got[1]], one[2][got[1]])
        assert torch.equal(got[3][real], one[3][real])
    empty = k1.fused_lookup_sharded_mesh(mesh, placed, q[:0], h, 8)
    assert all(t.shape == (0,) for t in empty)
    kb, vb, mb = port.scan_batch_sharded(stk, q[:256], count=40, height=h)
    km, vm, mm = port.scan_batch_sharded_mesh(mesh, placed, q[:256],
                                              count=40, height=h)
    torch.cuda.synchronize()
    assert torch.equal(mb, mm)
    assert torch.equal(kb[mb], km[mb]) and torch.equal(vb[mb], vm[mb])


@pytest.mark.parametrize("D", MESH_DEVICES)
def test_overlay_merge_stacked_mesh_matches_plain(cuda, D):
    """K2's stacked form once a position == the one-launch stacked form ==
    its plain version, on 8 rows of every kind."""
    from repro_torch.parallel import index_mesh
    rng = np.random.default_rng(40 + D)
    pool = rng.choice(2**60, size=40_000, replace=False).astype(np.uint64)
    rows = [(_pack(rng, [], 2048), _pack(rng, pool[:40], 64)),
            (_pack(rng, pool[:64], 2048), _pack(rng, pool[:64], 64)),
            (_pack(rng, pool[:2000], 2048), _pack(rng, pool[1990:2030], 64)),
            (_pack(rng, pool[:100], 2048), _pack(rng, [], 64))] * 2
    pa = torch.stack([port.overlay_from_numpy(a, cuda)["ov_pack"]
                      for a, _ in rows])
    pb = torch.stack([port.overlay_from_numpy(b, cuda)["ov_pack"]
                      for _, b in rows])
    n = k2.overlay_merge_stacked_mesh.launches
    got = k2.overlay_merge_stacked_mesh(index_mesh(D, devices=[cuda] * D),
                                        pa, pb, 4096)
    assert k2.overlay_merge_stacked_mesh.launches == n + D
    _same([got], [k2.overlay_merge_stacked(pa, pb, 4096)])
    _same([got], [k2.merge_overlay_stacked_torch(pa.cpu(), pb.cpu(),
                                                 4096).to(cuda)])


@pytest.mark.parametrize("D", MESH_DEVICES)
def test_mesh_engine_on_card_matches_cpu(cuda, D):
    """The mesh engine on cuda:0 named D times == the one-device engine on
    the CPU, request for request, with K1 launched D times a read batch."""
    from repro_torch.core import partition_bulkload
    from repro_torch.parallel import index_mesh
    from repro_torch.serving import ShardedIndexEngine
    keys = make_dataset("osm", 6_000, seed=2)
    rng = np.random.default_rng(5)
    trace = []
    for _ in range(6):
        fresh = rng.integers(1, 2**60, 40, dtype=np.uint64)
        trace.append([("insert", int(k), int(k) % 91) for k in fresh]
                     + [("delete", int(k)) for k in rng.choice(keys, 10)]
                     + [("get", int(k)) for k in rng.choice(keys, 60)]
                     + [("get", int(k)) for k in fresh[:10]]
                     + [("scan", int(k), 0, 50) for k in rng.choice(keys, 4)])
    outs = []
    for mesh in (None, index_mesh(D, devices=[cuda] * D)):
        part = partition_bulkload(keys, payloads_for(keys), 3,
                                  cfg=AulidConfig(**GEOMS["512b"]))
        eng = ShardedIndexEngine(part, mesh=mesh, gamma=0.02,
                                 async_compact=False,
                                 device="cpu" if mesh is None else None)
        n = k1.fused_lookup_sharded_mesh.launches
        outs.append([(r.op, r.key, tuple(r.result)
                      if isinstance(r.result, list) else r.result)
                     for step in trace for r in _step(eng, step)])
    assert outs[0] == outs[1]
    assert k1.fused_lookup_sharded_mesh.launches == n + 2 * D * len(trace)
    assert eng.stats()["mesh_devices"] == D


def _step(eng, step):
    reqs = [eng.submit(*args) for args in step]
    eng.step()
    return reqs


EDGES = np.array([0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 2, UM],
                 dtype=np.uint64)


@pytest.mark.parametrize("C", [7, 32, 256])
def test_leaf_search_kernel_matches_plain(cuda, C):
    """Present, absent and edge keys; padded rows; rank == C (payload 0)
    on full rows; rows out of range are clamped by both."""
    rng = np.random.default_rng(C)
    L, Q = 64, 3000
    keys = np.sort(rng.integers(0, UM, (L, C), dtype=np.uint64), axis=1)
    keys[1::3, C // 2:] = UM
    keys[0] = np.sort(np.resize(EDGES, C))
    pay = rng.integers(0, UM, (L, C), dtype=np.uint64)
    rows = rng.integers(0, L, Q).astype(np.int32)
    q = keys[rows, rng.integers(0, C, Q)]
    q[1::4] = rng.integers(0, UM, q[1::4].shape[0], dtype=np.uint64)
    rows[:EDGES.shape[0]] = 0
    q[:EDGES.shape[0]] = EDGES
    full = np.nonzero(keys[:, -1] < UM)[0]
    rows[-64:] = rng.choice(full, 64)
    q[-64:] = keys[rows[-64:], -1] + np.uint64(1)
    rows[-70:-64] = [-5, -1, L, L + 9, 2**31 - 1, -2**31]
    kt = keys_to_tensor(keys.reshape(-1), cuda).reshape(L, C)
    pt = torch.from_numpy(pay.view(np.int64).copy()).to(cuda)
    rt = torch.from_numpy(rows).to(cuda)
    qt = keys_to_tensor(q, cuda)
    n = k4.leaf_search.launches
    got = k4.leaf_search(kt, pt, rt, qt)
    assert k4.leaf_search.launches == n + 1
    _same(got, k4.leaf_search_plain(kt, pt, rt, qt))
    assert not got[1][-64:].any() and not got[0][-64:].any()
    assert got[1][:min(C, EDGES.shape[0])].all()


# K4's row widths: PA rows (<= 64), the leaf row (256), BT rows (<= 1020),
# and around the search's part sizes (33, 33^2 = 1089)
K4_CAPS = [1, 2, 8, 32, 33, 64, 255, 256, 257, 1020, 1089]


def _k4_case(rng, C: int, dev):
    """(48, C) sorted rows: random keys, padded tails, duplicate runs, the
    u64 extremes, all padding; queries present, absent, edge keys, above
    every key of a full row (rank == C), on rows out of range."""
    L = 48
    keys = np.sort(rng.integers(0, UM, (L, C), dtype=np.uint64), axis=1)
    keys[1::4, rng.integers(1, C + 1):] = UM
    runs = np.repeat(rng.integers(1, UM, C, dtype=np.uint64),
                     rng.integers(1, 9, C))
    keys[2::4] = np.sort(np.resize(runs, C))
    keys[0] = np.sort(np.resize(EDGES, C))
    keys[3] = UM
    pay = rng.integers(0, UM, (L, C), dtype=np.uint64)
    Q = 2000
    rows = rng.integers(0, L, Q).astype(np.int32)
    q = keys[rows, rng.integers(0, C, Q)]
    q[1::5] = rng.integers(0, UM, q[1::5].shape[0], dtype=np.uint64)
    q[2::5] += np.uint64(1)
    full = np.nonzero(keys[:, -1] < UM)[0]
    rows[-40:] = rng.choice(full, 40)
    q[-40:] = keys[rows[-40:], -1] + np.uint64(1)        # rank == C
    rows[:EDGES.shape[0]] = 0
    q[:EDGES.shape[0]] = EDGES
    rows[-46:-40] = [-5, -1, L, L + 9, 2**31 - 1, -2**31]
    return (keys_to_tensor(keys.reshape(-1), dev).reshape(L, C),
            torch.from_numpy(pay.view(np.int64).copy()).to(dev),
            torch.from_numpy(rows).to(dev), keys_to_tensor(q, dev))


def _k4_batch(rt, qt, Q: int):
    """The case's rows and queries repeated to a batch of ``Q``."""
    reps = Q // rt.shape[0] + 1
    return rt.repeat(reps)[:Q].contiguous(), qt.repeat(reps)[:Q].contiguous()


@pytest.mark.parametrize("C", K4_CAPS)
def test_leaf_search_lanes_match_plain(cuda, C):
    """K4's in-row search == its plain version bit for bit at every group
    size ``k4_lanes`` gives this width (each reached by the largest batch
    that gets it; one past the last halving for 1 lane), at every width, on
    batches of 0, 1 and 33 queries (a batch that fills no warp) and the
    whole case; rank == C gives payload 0 and no hit."""
    rng = np.random.default_rng(C + 1)
    kt, pt, rt, qt = _k4_case(rng, C, cuda)
    for Q in (0, 1, 33, qt.shape[0]):
        n = k4.leaf_search.launches
        got = k4.leaf_search(kt, pt, rt[:Q], qt[:Q])
        assert k4.leaf_search.launches == n + (Q > 0)
        _same(got, k4.leaf_search_plain(kt, pt, rt[:Q], qt[:Q]))
    assert not got[1][-40:].any() and not got[0][-40:].any()
    assert got[1][:min(C, EDGES.shape[0])].all()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    room = sms * k4.THREADS_PER_SM
    cover = k4.k4_lanes(C, 1, sms)
    lanes = cover
    while lanes >= 1:
        Q = room // lanes + (lanes == 1)
        assert k4.k4_lanes(C, Q, sms) == lanes
        rows, q = _k4_batch(rt, qt, Q)
        _same(k4.leaf_search(kt, pt, rows, q),
              k4.leaf_search_plain(kt, pt, rows, q))
        lanes //= 2


def test_leaf_search_lanes_from_the_batch(cuda):
    """Leaf-width batches that get each group size from ``k4_lanes`` (the
    largest that gets it; one past the last halving for 1 lane) equal the
    plain version; the launcher refuses a group size it has no kernel for
    (3, 32) with ``cudaErrorInvalidValue``, and the wrapper's check
    raises on it."""
    rng = np.random.default_rng(3)
    kt, pt, rt, qt = _k4_case(rng, 256, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    room = sms * k4.THREADS_PER_SM
    for lanes in (16, 8, 4, 2, 1):
        Q = room // lanes + (lanes == 1)     # the largest batch that gets it
        assert k4.k4_lanes(256, Q, sms) == lanes
        rows, q = _k4_batch(rt, qt, Q)
        _same(k4.leaf_search(kt, pt, rows, q),
              k4.leaf_search_plain(kt, pt, rows, q))
    lib = k4._build.load("leaf_search", k4._bind)
    out = torch.empty(qt.shape[0], dtype=torch.int64, device=cuda)
    found = torch.empty(qt.shape[0], dtype=torch.bool, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for lanes in (3, 32):
        err = lib.leaf_search_launch(
            kt.data_ptr(), pt.data_ptr(), kt.shape[0], kt.shape[1],
            rt.data_ptr(), qt.data_ptr(), qt.shape[0], out.data_ptr(),
            found.data_ptr(), lanes, stream)
        assert err == 1                      # cudaErrorInvalidValue
        with pytest.raises(RuntimeError):
            k4._build.check(err, "leaf_search")


@pytest.mark.parametrize("name", ["covid", "planet", "genome", "osm"])
def test_probe_level_kernel_matches_plain(cuda, name):
    """Every slot of the mirror (stale hops, chains leaving the block, chain
    ends, the partial last block) and the root predictions."""
    keys = make_dataset(name, 50_000, seed=1)
    idx = Aulid(BlockDevice(), cfg=AulidConfig(**GEOMS["512b"]))
    idx.bulkload(keys, payloads_for(keys))
    di = build_device_index(idx)
    arrs = port.device_arrays(di, cuda)
    pi = k5.ProbeIndex(arrs, di.inner_height)
    S = arrs["slot_tag"].shape[0]
    rng = np.random.default_rng(5)
    q = keys_to_tensor(np.resize(_queries(keys, rng), S), cuda)
    slots = torch.arange(S, dtype=torch.int32, device=cuda)
    pred = pi.predict(torch.zeros_like(q), key_f64(q))
    for s in (slots, pred, slots.flip(0).contiguous()):
        n = k5.probe_level.launches
        got = k5.probe_level(arrs, s, q)
        assert k5.probe_level.launches == n + 1
        _same(got, k5.probe_level_plain(arrs, s, q))


def test_overlay_probe_kernel_matches_plain(cuda):
    """An empty overlay, one of upserts and tombstones, a full pack; edge
    keys and the UINT64_MAX query (which meets the padding)."""
    rng = np.random.default_rng(11)
    full = DeltaOverlay()
    for k in rng.choice(2**40, full.arrays()["ov_keys"].shape[0],
                        replace=False):
        full.record_insert(int(k), 3)
    mixed = DeltaOverlay()
    live = rng.choice(2**62, 3000, replace=False).astype(np.uint64)
    for i, k in enumerate(live):
        if i % 4 == 3:
            mixed.record_delete(int(k))
        else:
            mixed.record_insert(int(k), int(k) + 5)
    q = keys_to_tensor(np.concatenate(
        [live, rng.integers(0, 2**62, 2000, dtype=np.uint64), EDGES]), cuda)
    for ov, padded in ((DeltaOverlay(), True), (mixed, True), (full, False)):
        ovr = port.overlay_arrays(ov, cuda)
        n = k3.overlay_probe.launches
        got = k3.overlay_probe(ovr, q)
        assert k3.overlay_probe.launches == n + 1
        _same(got, k3.overlay_probe_plain(ovr, q))
        # UINT64_MAX meets the padding; past a full pack its rank is cap
        assert bool(got[1][-1]) == padded
        assert not got[2][-1] and got[0][-1] == 0


# K3's 33-way warp search at caps around its part sizes (33, 33^2 = 1089,
# 33^3 = 35937) and the served 2^24; batches that are not a multiple of a
# block's 8 warps
K3_CAPS = [1, 2, 32, 33, 34, 1088, 1089, 1090, 35937, 35938, 1 << 24]
K3_BATCHES = [1, 7, 8193]


def _k3_lane_batches(dev) -> dict:
    """A batch for each group size K3 takes below a warp (16, 8, 4, 2
    lanes a query, then 1): the largest that gets it, less one, so that
    it fills no whole block; and one query past the card's room."""
    room = torch.cuda.get_device_properties(dev).multi_processor_count \
        * k3.RESIDENT_THREADS
    out = {g: room // g - 1 for g in (16, 8, 4, 2)} | {1: room + 1}
    assert {g: k3.k3_lanes(Q, room // k3.RESIDENT_THREADS)
            for g, Q in out.items()} == {g: g for g in out}
    return out


def _k3_queries(pack, rng):
    """Every live key, every gap between them (key +- 1), below all keys,
    biased INT64_MIN and INT64_MAX (u64 0 and max, the padding key), and
    random keys; shuffled, the edges first."""
    live = pack[0][pack[0] != UM]
    gaps = np.concatenate([live - np.uint64(1), live + np.uint64(1)]) \
        if live.size else np.empty(0, np.uint64)
    edges = np.array([0, UM, live[0] - np.uint64(1) if live.size else 5],
                     np.uint64)
    rest = np.concatenate([live, gaps, rng.integers(0, UM, 500,
                                                    dtype=np.uint64)])
    return np.concatenate([edges, rng.permutation(rest)])


@pytest.mark.parametrize("fill", ["tombstones", "padding"])
@pytest.mark.parametrize("cap", K3_CAPS)
def test_overlay_probe_warp_search_matches_plain(cuda, cap, fill):
    """K3 == its plain version bit for bit: a pack full of live entries (a
    quarter tombstones; 28,160 live past 35,938 slots, the served pack's
    count) or all padding, at every cap, for the whole query set and for
    its first 1, 7 and 8193 queries (a warp a query), and for batches that
    get each smaller group of lanes (the query set repeated)."""
    rng = np.random.default_rng(cap)
    live = 0 if fill == "padding" else min(cap, 28_160 if cap > 35_938
                                           else cap)
    keys = np.sort(rng.choice(2**62, live, replace=False).astype(np.uint64)
                   + np.uint64(2))
    if live == cap and cap > 1:
        keys[-1] = UM - np.uint64(1)   # a key just below the padding's
    pack = _pack(rng, keys, cap)
    ovr = port.overlay_from_numpy(pack, cuda)
    qn = _k3_queries(pack, rng)
    for Q in K3_BATCHES + list(_k3_lane_batches(cuda).values()) \
            + [qn.size]:
        q = keys_to_tensor(np.resize(qn, Q), cuda)
        n = k3.overlay_probe.launches
        got = k3.overlay_probe(ovr, q)
        assert k3.overlay_probe.launches == n + 1
        _same(got, k3.overlay_probe_plain(ovr, q))
    # INT64_MAX (u64 max) meets the padding unless the pack is full
    assert bool(got[1][1]) == (live < cap) and not got[2][1]
    if live:
        assert got[1][3:].any()


K5_BATCHES = [1, 255, 257]


@pytest.mark.parametrize("name", ["covid", "osm"])
def test_probe_level_walks_match_plain(cuda, name):
    """K5 == its plain version bit for bit on walks of 0, 1, 2 and 3 stale
    hops, on chains that leave the block (KIND_CONT) and that end
    (KIND_END), on slots below 0 and at or past ``n_slots``, in batches of
    1 (each case alone), 255 and 257."""
    keys = make_dataset(name, 50_000, seed=1)
    idx = Aulid(BlockDevice(), cfg=AulidConfig(**GEOMS["512b"]))
    idx.bulkload(keys, payloads_for(keys))
    arrs_cpu = port.device_arrays(build_device_index(idx), "cpu")
    S = arrs_cpu["slot_tag"].shape[0]
    rng = np.random.default_rng(4)
    qn = np.resize(_queries(keys, rng), S)
    q_cpu = keys_to_tensor(qn, "cpu")
    slots = torch.arange(S, dtype=torch.int32)
    kind, _ = k5.probe_level_plain(arrs_cpu, slots, q_cpu)
    _, hops, _ = k5.probe_walk(arrs_cpu, slots, q_cpu)
    picks = [int(np.flatnonzero((hops == h).numpy())[0]) for h in range(4)]
    picks += [int(np.flatnonzero((kind == c).numpy())[0])
              for c in (k5.KIND_CONT, k5.KIND_END)]
    cs = slots[picks].tolist() + [-1, -2**31, S, S + 127, 2**31 - 1]
    cq = qn[picks].tolist() + rng.choice(keys, 5).tolist()
    arrs = port.device_arrays(build_device_index(idx), cuda)

    def same(sl, qv):
        s_t = torch.tensor(sl, dtype=torch.int32, device=cuda)
        q_t = keys_to_tensor(np.array(qv, np.uint64), cuda)
        n = k5.probe_level.launches
        got = k5.probe_level(arrs, s_t, q_t)
        assert k5.probe_level.launches == n + 1
        _same(got, k5.probe_level_plain(arrs, s_t, q_t))

    for sl, qv in zip(cs, cq):
        same([sl], [qv])
    for Q in K5_BATCHES[1:]:
        idx_r = rng.integers(0, S, Q - len(cs))
        same(cs + slots[idx_r].tolist(), cq + qn[idx_r].tolist())


def test_staged_read_on_card_matches_cpu(cuda):
    """The staged read (K5 rounds, K4 on PA/BT and leaf rows) on the card ==
    its plain path on the CPU, rounds included, and == K1's snapshot read
    on found and found payloads."""
    keys = make_dataset("osm", 50_000, seed=1)
    idx = Aulid(BlockDevice(), cfg=AulidConfig(**GEOMS["512b"]))
    idx.bulkload(keys, payloads_for(keys))
    di = build_device_index(idx)
    rng = np.random.default_rng(2)
    qn = _queries(keys, rng)
    out = []
    for dev in ("cpu", cuda):
        pi = k5.ProbeIndex(port.device_arrays(di, dev), di.inner_height)
        out.append(k5.inner_probe_lookup(pi, keys_to_tensor(qn, dev),
                                         count_rounds=True))
    n4, n5 = k4.leaf_search.launches, k5.probe_level.launches
    pi = k5.ProbeIndex(port.device_arrays(di, cuda), di.inner_height)
    q = keys_to_tensor(qn, cuda)
    trace = []
    pay, found, rounds = k5.inner_probe_lookup(pi, q, count_rounds=True,
                                               trace=trace)
    assert k5.probe_level.launches > n5 and k4.leaf_search.launches > n4
    plain = {"probe_level": k5.probe_level_plain,
             "leaf_search": k4.leaf_search_plain}
    for fn, args, got in trace:      # every launch == its plain version
        _same(got, plain[fn](*args))
    assert rounds == out[0][2] == out[1][2] >= di.inner_height
    for g, e in zip(out[1][:2], out[0][:2]):
        assert torch.equal(g.cpu(), e)
    k1_pay, k1_found, _ = k1.fused_lookup(pi.arrs, None, q,
                                          max(di.max_inner_height, 3))
    assert torch.equal(found, k1_found)
    assert torch.equal(torch.where(found, pay, 0), k1_pay)


# (B, H, Hkv, Dh, page, P, NP): the reference's three geometries
# (test_kernels.py:144-148), then qwen3-4b's decode geometry (32 heads over
# 8 kv heads of 128, pages of 16, 32 pages a row, 8 slots)
K6_GEOMS = [(4, 8, 2, 64, 16, 64, 8), (2, 16, 16, 128, 64, 32, 4),
            (1, 4, 1, 32, 8, 16, 3), (8, 32, 8, 128, 16, 512, 32)]
# float32: 1e-5, the online softmax against the full one; bfloat16: 3e-2,
# the reference's own (both round one float32 result to bf16)
K6_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


def _k6_inputs(geom, dtype, dev, seed):
    B, H, hk, dh, page, P, NP = geom
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, H, dh), generator=g).to(dev, dtype)
    kp = torch.randn((P, page, hk, dh), generator=g).to(dev, dtype)
    vp = torch.randn((P, page, hk, dh), generator=g).to(dev, dtype)
    table = torch.randint(0, P, (B, NP), generator=g, dtype=torch.int32)
    lens = torch.randint(1, NP * page, (B,), generator=g, dtype=torch.int32)
    lens[0] = 0                                   # every logit -1e30
    lens[-1] = NP * page                          # every token live
    return table.to(dev), lens.to(dev), q, kp, vp


def _k6_close(got, exp):
    torch.cuda.synchronize()
    tol = K6_TOL[got.dtype]
    assert got.dtype == exp.dtype and got.shape == exp.shape
    torch.testing.assert_close(got.float(), exp.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", K6_GEOMS, ids=["gqa", "mha", "mqa",
                                                "qwen3-4b"])
def test_paged_attention_kernel_matches_plain(cuda, geom, dtype):
    args = _k6_inputs(geom, dtype, cuda, seed=geom[0] * geom[1])
    n = k6.paged_attention.launches
    got = k6.paged_attention(*args)
    assert k6.paged_attention.launches == n + 1
    _k6_close(got, k6.paged_attention_plain(*args))


def _k6_split_case(name, dtype, dev):
    """K6 inputs that force several splits of ``_split_plan`` (and empty
    ones past a row's walk): qwen3-4b's heads (32 over 8 kv heads of 128,
    pages of 16) unless named otherwise."""
    H, hk, dh, page = {"gemma2": (16, 8, 256, 16),     # 2 heads a block
                       "group16": (32, 2, 64, 16)}.get(  # 2 blocks a group
                           name, (32, 8, 128, 16))
    g = torch.Generator(device="cpu").manual_seed(len(name))
    if name == "long":            # NP = 256, lengths 2048-4096
        B, NP, P = 4, 256, 1024
        lens = torch.randint(2048, 4097, (B,), generator=g)
        table = torch.randperm(P, generator=g)[:B * NP].reshape(B, NP)
    else:
        B, NP, P = 6, 32, 96
        pps, _ = k6._split_plan(B, hk, NP, page)
        edge = 3 * pps * page     # the third split's end
        lens = torch.tensor({
            "boundary": [edge - 1, edge, edge + 1, pps * page, 1, 17],
            "one": [1, 1, 2, 15, 16, 17],
            "empty": [0, 0, 5, 300, NP * page, 1],
            "shared": [200, 201, 64, 512, 33, 0],
            "gemma2": [0, 1, edge, 511, 97, 250],
            "group16": [0, 1, edge + 1, 512, 160, 33]}[name])
        table = torch.randint(0, P, (B, NP), generator=g)
        if name == "shared":      # shared prefixes and pages across rows
            table[1, :13] = table[0, :13]
            table[2, 4:] = table[3, :NP - 4]
            table[5, ::2] = table[0, 7]
    assert k6._split_plan(B, hk, NP, page)[1] > 1
    q = torch.randn((B, H, dh), generator=g).to(dev, dtype)
    kp = torch.randn((P, page, hk, dh), generator=g).to(dev, dtype)
    vp = torch.randn((P, page, hk, dh), generator=g).to(dev, dtype)
    return (table.to(dev, torch.int32), lens.to(dev, torch.int32), q, kp,
            vp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["long", "boundary", "one", "empty",
                                  "shared", "gemma2", "group16"])
def test_paged_attention_splits_match_plain(cuda, name, dtype):
    """Several splits a row, empty splits past the walk, lengths at a
    split's boundary and either side, length 1, a length-0 row whose table
    spans every split, pages shared between rows; then gemma2-9b's heads
    (Dh 256, 2 query heads a kv head) and a group of 16 query heads."""
    args = _k6_split_case(name, dtype, cuda)
    n = k6.paged_attention.launches
    got = k6.paged_attention(*args)
    assert k6.paged_attention.launches == n + 1
    _k6_close(got, k6.paged_attention_plain(*args))


def test_paged_attention_rejects_other_head_dims(cuda):
    table, lens, q, kp, vp = _k6_inputs((2, 4, 2, 48, 8, 8, 2),
                                        torch.float32, cuda, seed=3)
    with pytest.raises(ValueError):
        k6.paged_attention(table, lens, q, kp, vp)


def test_paged_attention_on_pool_views(cuda):
    """K6 reads a layer's view of the (L, P, page, Hkv, Dh) pool without a
    copy, and pages strided further apart ((P, L, ...) layout); out-of-range
    page ids are clamped as in the plain version."""
    B, H, hk, dh, page, P, NP = 3, 8, 2, 64, 16, 20, 5
    table, lens, q, _, _ = _k6_inputs((B, H, hk, dh, page, P, NP),
                                      torch.float32, cuda, seed=4)
    table[1, 2], table[2, 0] = -3, P + 7
    pool = torch.randn((4, P, page, hk, dh), device=cuda)
    for kp in (pool[2], pool.transpose(0, 1).contiguous()[:, 1]):
        got = k6.paged_attention(table, lens, q, kp, kp)
        _k6_close(got, k6.paged_attention_plain(table, lens, q, kp, kp))
    with pytest.raises(ValueError):
        k6.paged_attention(table, lens, q, pool[2].transpose(1, 2), pool[2])


def _lm_pair(cuda):
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = dataclasses.replace(
        get_config("qwen3-4b").reduced(), n_layers=2, d_model=64, n_heads=2,
        n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=128,
        compute_dtype="float32")
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, model, copy.deepcopy(model).to(cuda)


@pytest.mark.parametrize("trace", ["churn", "empty-slot"])
def test_serve_engine_on_card_matches_cpu(cuda, trace):
    """The LM engine on the card (K1 translations, K6 attention) == on the
    CPU (their plain versions): equal tokens, state and page pools, logits
    within 1e-4 at every step."""
    from repro_torch.serving import Request, ServeEngine
    cfg, cpu_model, card_model = _lm_pair(cuda)
    if trace == "churn":
        kw = dict(slots=2, page_size=8, n_pages=64, max_pages_per_seq=8)
        rng = np.random.default_rng(1)
        reqs = [(i, rng.integers(1, 100, 4).tolist(), 3) for i in range(7)]
    else:
        kw = dict(slots=2, page_size=4, n_pages=16, max_pages_per_seq=4)
        reqs = [(0, [1, 2, 3], 10)]
    engines = [ServeEngine(cfg, cpu_model, device="cpu", **kw),
               ServeEngine(cfg, card_model, device=cuda, **kw)]
    for eng in engines:
        for rid, prompt, max_new in reqs:
            eng.submit(Request(rid=rid, prompt=list(prompt), max_new=max_new))
    n1, n6 = k1.fused_lookup.launches, k6.paged_attention.launches
    steps = 0
    while engines[0].queue or any(r is not None for r in engines[0].slots):
        a, b = (e.step() for e in engines)
        steps += 1
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)
        for e in engines:
            assert e.steps == steps
        assert [(r.rid, r.out) for r in engines[0].completed] == \
            [(r.rid, r.out) for r in engines[1].completed]
        assert engines[0].slot_pos.tolist() == engines[1].slot_pos.tolist()
    assert k1.fused_lookup.launches >= n1 + steps
    assert k6.paged_attention.launches == n6 + steps * cfg.n_layers
    for k in ("k", "v"):
        torch.testing.assert_close(engines[1].kv[k].cpu(), engines[0].kv[k],
                                   atol=1e-5, rtol=1e-5)
    assert engines[0].pool_pages.free == engines[1].pool_pages.free
    assert len(engines[1].completed) == len(reqs)


@pytest.mark.parametrize("arch,kv", [("qwen3-4b", "float32"),
                                     ("gemma2-9b", "int8"),
                                     ("qwen2-moe-a2.7b", "float32")])
def test_contiguous_decode_on_card_matches_cpu(cuda, arch, kv):
    """``prefill`` then 6 ``decode_step``s through the step functions on the
    card == on the CPU, tiny float32 configs with a float32 or int8 cache
    (gemma2: its 16-token window shorter than the prompt, softcaps;
    qwen2-moe: shared experts, whose combine the card sums with atomics):
    equal greedy tokens, logits within 1e-4, int8 codes within one at <=
    0.1% of the cache."""
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import model as M
    cfg = dataclasses.replace(
        get_config(arch).reduced(), n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=96, vocab_size=128,
        compute_dtype="float32", kv_cache_dtype=kv,
        sliding_window=16 if arch == "gemma2-9b" else 0)
    cpu_model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    models = {"cpu": cpu_model, cuda: copy.deepcopy(cpu_model).to(cuda)}
    B, S = 3, 24
    toks = np.random.default_rng(1).integers(0, 128, (B, S)).astype(np.int32)
    out = {}
    for dev, model in models.items():
        cache = M.init_zeros(M.cache_specs(cfg, B, S + 6), dev)
        logits, cache = make_prefill_step(cfg, dev)(model, {"tokens": toks},
                                                    cache)
        decode = make_decode_step(cfg, dev)
        steps = [logits]
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        for t in range(6):
            logits, nxt, cache, _ = decode(model, tok, np.full(B, S + t),
                                           cache, {})
            steps.append(logits)
            tok = nxt[:, None]
        out[dev] = ([x.cpu() for x in steps], {k: v.cpu()
                                               for k, v in cache.items()})
    (a, ca), (b, cb) = out["cpu"], out[cuda]
    for x, y in zip(a, b):
        torch.testing.assert_close(y, x, atol=1e-4, rtol=1e-4)
        assert torch.equal(y.argmax(-1), x.argmax(-1))
    for k in ca:
        if ca[k].dtype == torch.int8:
            d = (cb[k].int() - ca[k].int()).abs()
            assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
        else:
            torch.testing.assert_close(cb[k], ca[k], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "granite-moe-1b-a400m"])
def test_grouped_moe_on_card_matches_cpu(cuda, arch):
    """``moe_ffn`` under a (data=2, model=2) ``ShardingContext`` (G = 4
    dispatch groups of capacity C/4; the mesh names cuda:0 four times) on
    the card == on the CPU, a float32 reduced config whose first 28
    tokens lean towards expert 0 (its queues overflow): output and aux
    loss within 1e-4, the contiguous tests' tolerance (the card's combine
    sums with atomics)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import ShardingContext, set_context
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="float32", compute_dtype="float32")
    g = torch.Generator().manual_seed(28)
    layer = moe.MoE(cfg, torch.float32)
    with torch.no_grad():
        for t in layer.parameters():
            t.copy_(torch.randn(t.shape, generator=g) / np.sqrt(t.shape[-2]))
    x = torch.randn((4, 16, cfg.d_model), generator=g)
    r0 = layer.router.detach()[:, 0]
    x.view(-1, cfg.d_model)[:28] += 4 * r0 / r0.norm()
    card = moe.MoE(cfg, torch.float32, cuda)
    card.load_state_dict(layer.state_dict())
    set_context(ShardingContext(make_host_mesh(data=2, model=2,
                                               devices=[cuda] * 4)))
    try:
        assert moe._dispatch_groups(4) == 4
        y, aux = moe.moe_ffn(cfg, layer, x)
        yc, auxc = moe.moe_ffn(cfg, card, x.to(cuda))
    finally:
        set_context(None)
    torch.testing.assert_close(yc.cpu(), y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(auxc.cpu(), aux, atol=1e-4, rtol=1e-4)


def test_grouped_remat_train_step_on_card(cuda):
    """A ``make_train_step`` of reduced float32 granite-moe under a
    (data=2, model=2) ``ShardingContext`` over cuda:0 named four times
    (G = 4), with ``cfg.remat``: the backward runs on autograd's device
    thread, and the recomputed layers must see the forward's groups.  Its
    loss, gnorm and parameters equal those of the same step without remat
    within the train test's tolerances (1e-4 relative; 1e-3 of a leaf's
    largest weight), and they part from a step without a context (the
    batch drops routes at G = 4 that G = 1 keeps)."""
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel.sharding import ShardingContext, installed
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                              param_dtype="float32", compute_dtype="float32")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 33))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    start = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    ctx = ShardingContext(make_host_mesh(data=2, model=2,
                                         devices=[cuda] * 4))
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    runs = {}
    for name, remat, c in (("remat", True, ctx), ("kept", False, ctx),
                           ("ungrouped", False, None)):
        model = copy.deepcopy(start).to(cuda)
        opt = adamw_init(model)
        step = make_train_step(dataclasses.replace(cfg, remat=remat),
                               opt_cfg, cuda)
        with installed(c):
            m = step(model, opt, batch)[2]
        runs[name] = (model, m)
    (a, ma), (b, mb) = runs["remat"], runs["kept"]
    for k in ("loss", "gnorm"):
        torch.testing.assert_close(ma[k], mb[k], rtol=1e-4, atol=0)
    for (n, x), y in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-3 * float(
            y.detach().abs().max()), msg=n)
    assert float(runs["ungrouped"][1]["gnorm"]) != float(mb["gnorm"])


@pytest.mark.parametrize("n", [64, 1024, 5000, 70_000])
def test_softmax_over_its_input_equals_out_of_place(cuda, n):
    """``models.attention._sdpa`` writes the softmax over its float32
    logits (``out=``): on the card that equals the out-of-place softmax
    bit for bit, masked (-1e30) entries included, at row lengths on both
    sides of the kernel's register-resident limit."""
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((3, 4, n), generator=g, device=cuda) * 5
    x[:, :, n // 2:] = -1e30
    exp = torch.softmax(x, dim=-1)
    y = x.clone()
    assert torch.softmax(y, dim=-1, out=y).data_ptr() == y.data_ptr()
    assert torch.equal(y, exp)


_NORM_LEAVES = ("final_norm", "ln1", "ln2", "ln1_post", "ln2_post", "q_norm",
                "k_norm", "norm", "ln_x", "ln")


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-1b-a400m"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    """``make_train_step`` (phase 11 (a) of ``chip_smoke.py``): 3 steps on
    a reduced float32 config on the card == on the CPU, each from the
    CPU's parameters and moments, on one batch from the port's loader:
    loss, gnorm and lr within 1e-4 relative; every parameter within 1e-3
    of its leaf's largest effective weight (1 + s for a norm scale s).
    Adam's eps is 1e-5: its step is +-lr whatever the gradient's size, so
    an entry whose gradient lies near eps moves by up to lr for a rounding
    of its gradient (chip_smoke.py's TRAIN_OPT)."""
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import PackedDocStore, ShardedLoader, synth_corpus
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="float32", compute_dtype="float32")
    store = PackedDocStore(block_tokens=256)
    store.build(synth_corpus(64, cfg.vocab_size, seed=21))
    batch = ShardedLoader(store, 2, 64, seed=21).next_batch()
    cpu = M.init_params(cfg, torch.Generator().manual_seed(22), "cpu")
    card = copy.deepcopy(cpu).to(cuda)
    models = {"cpu": cpu, cuda: card}
    opts = {d: adamw_init(m) for d, m in models.items()}
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-5)
    for _ in range(3):
        with torch.no_grad():
            card.load_state_dict(cpu.state_dict())
            for k in ("mu", "nu"):
                for n, t in opts[cuda][k].items():
                    t.copy_(opts["cpu"][k][n])
            opts[cuda]["step"].copy_(opts["cpu"]["step"])
        m = {d: make_train_step(cfg, opt_cfg, d)(models[d], opts[d], batch)[2]
             for d in models}
        for k in ("loss", "gnorm", "lr"):
            torch.testing.assert_close(m[cuda][k].cpu(), m["cpu"][k],
                                       rtol=1e-4, atol=0)
        for (n, a), b in zip(card.named_parameters(), cpu.parameters()):
            b = b.detach()
            w = 1 + b if n.rsplit(".", 1)[-1] in _NORM_LEAVES else b
            torch.testing.assert_close(a.detach().cpu(), b, rtol=0,
                                       atol=1e-3 * float(w.abs().max()),
                                       msg=n)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b",
                                  "musicgen-medium", "llama-3.2-vision-11b"])
def test_family_steps_on_card_match_cpu(cuda, arch):
    """The ssm, hybrid, audio and vlm families (phase 10 (a) of
    ``chip_smoke.py``): ``forward``, ``prefill`` and 4 ``decode_step``s
    through the step functions on the card == on the CPU, float32 reduced
    configs with a float32 cache, each step from the CPU's cache and
    state: logits, caches and float32 states within 1e-4 (2e-3 for rwkv6,
    whose ln_x group norm amplifies a near-cancelling head, and zamba2,
    whose chunked scan multiplies by exp of a difference of two float32
    cumulative sums), bfloat16 shift and conv rows equal or one ulp apart
    (or within that tolerance)."""
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import model as M
    from repro_torch.models.common import bf16_near
    tol = 2e-3 if arch in ("rwkv6-1.6b", "zamba2-1.2b") else 1e-4
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32",
                              kv_cache_dtype="float32")
    cpu_model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    models = {"cpu": cpu_model, cuda: copy.deepcopy(cpu_model).to(cuda)}
    B, S, n = 3, 64, 4
    g = torch.Generator().manual_seed(1)
    batch = ({"frames": torch.randn((B, S, cfg.d_model), generator=g)}
             if cfg.family == "audio" else
             {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g)})
    if cfg.cross_attn_period:
        batch["patches"] = torch.randn((B, cfg.n_patches, cfg.d_model),
                                       generator=g)

    def same(a: dict, b: dict) -> None:
        assert a.keys() == b.keys()
        for k in a:
            x, y = a[k], b[k].cpu()
            if x.dtype == torch.bfloat16:
                assert bf16_near(x, y, tol), k
            else:
                torch.testing.assert_close(y, x, atol=tol, rtol=1e-4)

    fw = {d: M.forward(cfg, m, batch, device=d)[0].cpu()
          for d, m in models.items()}
    torch.testing.assert_close(fw[cuda], fw["cpu"], atol=tol, rtol=1e-4)
    logits, caches, states = {}, {}, {}
    for d, model in models.items():
        logits[d], caches[d] = make_prefill_step(cfg, d)(
            model, batch, M.init_zeros(M.cache_specs(cfg, B, S + n), d))
        states[d] = M.init_zeros(M.state_specs(cfg, B), d)
    same(caches["cpu"], caches[cuda])
    for t in range(n + 1):
        torch.testing.assert_close(logits[cuda].cpu(), logits["cpu"],
                                   atol=tol, rtol=1e-4)
        if t:
            same(states["cpu"], states[cuda])
        if t == n:
            break
        tok = logits["cpu"].argmax(-1).to(torch.int32)[:, None]
        caches[cuda] = {k: v.to(cuda) for k, v in caches["cpu"].items()}
        states[cuda] = {k: v.to(cuda) for k, v in states["cpu"].items()}
        for d, model in models.items():
            logits[d], _, caches[d], states[d] = make_decode_step(cfg, d)(
                model, tok, np.full(B, S + t), caches[d], states[d])


# ------------------------------------------------------------ the sharded path
def _stack(cuda, name, live, slots, n=50_000):
    from repro_torch.core import partition_bulkload
    from repro_torch.core.device_index import stack_device_indexes
    keys = make_dataset(name, n, seed=1)
    part = partition_bulkload(keys, payloads_for(keys), live,
                              cfg=AulidConfig(**GEOMS["512b"]))
    sdi = stack_device_indexes([build_device_index(sh) for sh in part.shards],
                               part.bounds, min_shards=slots)
    return keys, part, sdi, port.stacked_device_arrays(sdi, device=cuda)


@pytest.mark.parametrize("name,live,slots",
                         [("covid", 1, 0), ("osm", 3, 0), ("planet", 5, 8),
                          ("genome", 8, 0)],
                         ids=["covid-s1", "osm-s3", "planet-s5of8",
                              "genome-s8"])
def test_fused_lookup_sharded_kernel_matches_plain(cuda, name, live, slots):
    """K1's shard route == its plain version: edge keys, every bound and
    its neighbours (placeholder UINT64_MAX bounds included), with and
    without an overlay; routing equals the host partition's."""
    keys, part, sdi, stk = _stack(cuda, name, live, slots)
    h = max(sdi.max_inner_height, 3)
    rng = np.random.default_rng(5)
    near = [int(b) + d for b in sdi.bounds for d in (-1, 0, 1)
            if 0 <= int(b) + d <= 2**64 - 1]
    qn = np.concatenate([_queries(keys, rng),
                         np.array(near, dtype=np.uint64)])
    q = keys_to_tensor(qn, cuda)
    ov = DeltaOverlay()
    for k in rng.integers(0, 2**62, 200, dtype=np.uint64):
        ov.record_insert(int(k), int(k) % 1009)
    for k in rng.choice(keys, 100):
        ov.record_delete(int(k))
    for ovr in (None, port.overlay_arrays(ov, cuda)):
        n = k1.fused_lookup_sharded.launches
        got = k1.fused_lookup_sharded(stk, ovr, q, h)
        assert k1.fused_lookup_sharded.launches == n + 1
        _same(got, k1.lookup_sharded_plain(stk, ovr, q, h))
        assert (got[3].cpu().numpy() == part.shard_of_batch(qn)).all()
        assert got[1][:3000].any()


def test_overlay_merge_stacked_kernel_matches_plain(cuda):
    """K2's stacked form == its plain version, rows of every kind, and a
    row of the served shape's bytes (Ca = cap_out = 2^21, Cb = 64)."""
    rng = np.random.default_rng(8)
    pool = rng.choice(2**60, size=400_000, replace=False).astype(np.uint64)
    rows = [(_pack(rng, [], 4096), _pack(rng, pool[:300], 512)),
            (_pack(rng, pool[:512], 4096), _pack(rng, pool[:512], 512)),
            (_pack(rng, pool[:3000], 4096), _pack(rng, pool[2900:3300], 512)),
            (_pack(rng, pool[:4000], 4096), _pack(rng, pool[3900:4400], 512)),
            (_pack(rng, pool[:100], 4096), _pack(rng, [], 512))]
    for cap_out in (4096, 8192):
        pa = torch.stack([port.overlay_from_numpy(a, cuda)["ov_pack"]
                          for a, _ in rows])
        pb = torch.stack([port.overlay_from_numpy(b, cuda)["ov_pack"]
                          for _, b in rows])
        n = k2.overlay_merge_stacked.launches
        got = k2.overlay_merge_stacked(pa, pb, cap_out)
        assert k2.overlay_merge_stacked.launches == n + 1
        exp = k2.merge_overlay_stacked_torch(pa, pb, cap_out)
        torch.cuda.synchronize()
        assert torch.equal(got, exp)
    big = [(_pack(rng, pool[i * 40_000:(i + 1) * 40_000], 1 << 21),
            _pack(rng, pool[(i + 1) * 40_000 - 30:(i + 1) * 40_000 + 34], 64))
           for i in range(3)]
    pa = torch.stack([port.overlay_from_numpy(a, cuda)["ov_pack"]
                      for a, _ in big])
    pb = torch.stack([port.overlay_from_numpy(b, cuda)["ov_pack"]
                      for _, b in big])
    got = k2.overlay_merge_stacked(pa, pb, 1 << 21)
    exp = k2.merge_overlay_stacked_torch(pa, pb, 1 << 21)
    torch.cuda.synchronize()
    assert torch.equal(got, exp)


def _settle(eng):
    """Wait for the engine's background builds, so that every engine
    installs them at the same step boundary whatever its thread's speed."""
    for fut in list(eng._inflight.values()):
        fut.result()
    if eng._repart_inflight is not None:
        eng._repart_inflight[-1].result()


def test_sharded_engine_on_card_matches_cpu(cuda):
    """``ShardedIndexEngine`` on the card (K1's shard route, K2) == on the
    CPU (their plain versions), request for request, through background
    compactions and a forced split and merge."""
    from repro_torch.core import partition_bulkload
    from repro_torch.serving import ShardedIndexEngine
    keys = make_dataset("osm", 6_000, seed=1)
    rng = np.random.default_rng(3)
    engines = [ShardedIndexEngine(
        partition_bulkload(keys, payloads_for(keys), 4,
                           cfg=AulidConfig(**GEOMS["512b"])),
        device=device, gamma=0.01, repartition=True, split_ratio=1e9)
        for device in ("cpu", cuda)]
    n1, n2 = k1.fused_lookup_sharded.launches, k2.overlay_merge.launches
    outs = [[], []]
    for i in range(10):
        fresh = rng.integers(1, 2**60, 30, dtype=np.uint64)
        step = ([("insert", int(k), int(k) % 91) for k in fresh]
                + [("delete", int(k)) for k in rng.choice(keys, 8)]
                + [("get", int(k)) for k in rng.choice(keys, 60)]
                + [("get", int(k)) for k in fresh[:10]]
                + [("scan", int(k), 0, 40) for k in rng.choice(keys, 4)]
                + [("scan", int(b) - 2, 0, 40)
                   for b in engines[0].part.bounds[:2]])
        for out, eng in zip(outs, engines):
            reqs = [eng.submit(*a) for a in step]
            eng.step()
            out += [(r.op, r.key, tuple(r.result) if isinstance(r.result, list)
                     else r.result) for r in reqs]
            if i in (4, 7):
                eng.drain_compactions()
                assert eng.request_split(0) if i == 4 else \
                    eng.request_merge(1)
            _settle(eng)
    for e in engines:
        e.drain_compactions()
    assert outs[0] == outs[1]
    st = [e.stats() for e in engines]
    assert st[1]["read_backend"] == "cuda"
    for k in ("compactions", "swaps", "splits", "merges", "num_shards"):
        assert st[0][k] == st[1][k], k
    assert st[1]["swaps"] >= 1 and st[1]["splits"] == st[1]["merges"] == 1
    assert k1.fused_lookup_sharded.launches > n1
    assert k2.overlay_merge.launches > n2
