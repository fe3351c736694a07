"""The port's ``ShardedIndexEngine`` == the reference's, request for request.

Twin engines over the same range-partitioned keys serve the same seeded
mixed traces: the port on the CPU (the plain versions of K1's shard route
and K2), the reference on its jnp path; the traces of
``tests/test_sharded_engine.py`` also run through the port's own
monolithic ``IndexEngine``.  Every result must be equal, and so must the
engines' counters, across shard-local compaction (cold shards keep their
snapshot epoch), background compaction pumped by hand (``ManualExecutor``
set on both packages' ``_COMPACT_POOL``), forced splits and merges, a
failed split build, and synchronous against background repartitioning.
Where the twins step together, the port's served overlay pack equals the
reference's after every step (``test_torch_overlay_merge.check_served``:
the port's two packs keep padding past their fills).
"""
import numpy as np
import pytest

pytest.importorskip("jax")   # the reference; absent where only the port runs

from test_async_compaction import ManualExecutor
from test_torch_overlay_merge import check_served

from repro.core import AulidConfig as RefConfig
from repro.core import partition_bulkload as ref_partition
from repro.core.workloads import make_dataset, payloads_for
from repro.serving import ShardedIndexEngine as RefEngine
from repro.serving import index_engine as ref_ie

from repro_torch.core import (Aulid, AulidConfig, BlockDevice,
                              partition_bulkload)
from repro_torch.serving import IndexEngine, ShardedIndexEngine
from repro_torch.serving import index_engine as port_ie

SMALL_GEOM = dict(leaf_capacity=16, pa_classes=(4, 8), bt_child_capacity=15)
STAT_KEYS = ("steps", "reads_served", "writes_applied", "num_shards",
             "overlay_len", "compactions", "compactions_per_shard",
             "mirror_refreshes", "mirror_full_builds", "full_restacks",
             "swaps", "failed_swaps", "inflight", "pack_skips",
             "overlay_merges", "overlay_reseeds", "write_h2d_bytes",
             "splits", "merges", "repart_failures", "repart_inflight",
             "boundary_version", "shard_sizes", "read_shape_misses")


@pytest.fixture
def pools(monkeypatch):
    """Hand-pumped build pools, one for each package."""
    out = ManualExecutor(), ManualExecutor()
    monkeypatch.setattr(ref_ie, "_COMPACT_POOL", out[0])
    monkeypatch.setattr(port_ie, "_COMPACT_POOL", out[1])
    return out


def _pair(n=1_500, num_shards=3, **kw):
    keys = make_dataset("covid", n, seed=1)
    pays = payloads_for(keys)
    ref = RefEngine(ref_partition(keys, pays, num_shards,
                                  cfg=RefConfig(**SMALL_GEOM)),
                    backend="jnp", **kw)
    port = ShardedIndexEngine(partition_bulkload(
        keys, pays, num_shards, cfg=AulidConfig(**SMALL_GEOM)),
        device="cpu", **kw)
    return keys, ref, port


def _result(r):
    return tuple(r.result) if isinstance(r.result, list) else r.result


def _drive(eng, trace):
    out = []
    for step in trace:
        reqs = [eng.submit(*args) for args in step]
        eng.step()
        out.extend((r.op, r.key, _result(r)) for r in reqs)
    return out


def _same_stats(ref, port):
    a, b = ref.stats(), port.stats()
    assert {k: a[k] for k in STAT_KEYS} == {k: b[k] for k in STAT_KEYS}
    assert b["read_backend"] == "torch"


def _trace(keys, seed, steps=3):
    """The randomized mixed trace of the reference's equivalence test:
    per step 18 gets, 10 upserts, 5 deletes and 4 scans of 9-15."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(steps):
        reqs = []
        for _ in range(18):
            k = (int(rng.choice(keys)) if rng.random() < 0.6
                 else int(rng.integers(0, 2**50)))
            reqs.append(("get", k))
        for i in range(10):
            k = (int(rng.integers(0, 2**50)) if rng.random() < 0.7
                 else int(rng.choice(keys)))
            reqs.append(("insert", k, step * 100 + i))
        for _ in range(5):
            k = (int(rng.choice(keys)) if rng.random() < 0.6
                 else int(rng.integers(0, 2**50)))
            reqs.append(("delete", k))
        for _ in range(4):
            k = int(rng.choice(keys)) if rng.random() < 0.8 \
                else int(rng.integers(0, 2**50))
            reqs.append(("scan", k, 0, int(rng.integers(9, 16))))
        out.append(reqs)
    return out


@pytest.mark.parametrize("seed", [3, 11])
def test_randomized_trace_matches_reference_and_monolithic(seed):
    keys, ref, port = _pair()
    mono_idx = Aulid(BlockDevice(), cfg=AulidConfig(**SMALL_GEOM))
    mono_idx.bulkload(keys, payloads_for(keys))
    mono = IndexEngine(mono_idx, device="cpu")
    trace = _trace(keys, seed)
    got = []
    for step in trace:
        got += _both(ref, port, step)
    assert got == _drive(mono, trace)
    _same_stats(ref, port)
    for sh in port.shards:
        sh.idx.check_invariants()


def test_scan_across_boundary_with_step_writes():
    """A scan straddling a shard boundary sees same-step writes on both
    sides of it (overlay merge + successor chain)."""
    keys, ref, port = _pair()
    b = int(port.part.bounds[0])
    i = int(np.searchsorted(keys, np.uint64(b)))
    step = [("insert", b - 1 if b - 1 not in keys else b, 111),
            ("insert", b + 1, 222), ("delete", int(keys[i - 1])),
            ("scan", int(keys[i - 2]), 0, 10)]
    got = _drive(port, [step])
    assert got == _drive(ref, [step])
    scan = [k for k, _ in got[-1][2]]
    assert b + 1 in scan and int(keys[i - 1]) not in scan
    _same_stats(ref, port)


def _hot_shard_trace(part, hot, steps=3, per_step=30):
    lo = int(part.bounds[hot - 1]) + 1
    hi = int(part.bounds[hot])
    rng = np.random.default_rng(0)
    return [[("insert", int(k), int(k) % 1000)
             for k in rng.integers(lo, hi, per_step)]
            + [("get", int(k)) for k in rng.integers(lo, hi, 8)]
            for _ in range(steps)]


@pytest.mark.parametrize("async_compact", [False, True],
                         ids=["sync", "async"])
def test_cold_shards_keep_snapshot_epoch(pools, async_compact):
    """Writes confined to one shard's range compact that shard only; cold
    shards' mirrors keep their snapshot epoch, on both packages."""
    keys, ref, port = _pair(async_compact=async_compact)
    hot, cold = 1, (0, 2)
    before = [(sh.di.journal_epoch, sh.di.full_builds, sh.di.refreshes)
              for sh in port.shards]
    trace = _hot_shard_trace(port.part, hot)
    out = []
    for step in trace:
        out.append((_drive(ref, [step]), _drive(port, [step])))
        check_served(ref.ov_arrs, port.ov_arrs)
        assert pools[0].pump() == pools[1].pump()
    assert all(a == b for a, b in out)
    ref.drain_compactions()
    port.drain_compactions()
    _same_stats(ref, port)
    assert port.shards[hot].compactions >= 1
    for s in cold:
        sh = port.shards[s]
        assert sh.compactions == 0
        assert (sh.di.journal_epoch, sh.di.full_builds,
                sh.di.refreshes) == before[s], f"shard {s}"


def _storm(keys, rng, n):
    """A write storm over the whole key range, then reads of it."""
    ins = [int(k) for k in rng.integers(int(keys[0]), int(keys[-1]), n,
                                        dtype=np.uint64)]
    return ([("insert", k, k % 991) for k in ins]
            + [("delete", int(k)) for k in rng.choice(keys, 6)]
            + [("get", k) for k in ins[:12]]
            + [("get", int(k)) for k in rng.choice(keys, 12)]
            + [("scan", int(k), 0, 12) for k in rng.choice(keys, 3)])


def test_async_storm_matches_reference_and_sync(pools):
    """Every shard crosses its threshold in one step; the builds stay in
    flight over the next step, then install: the async port == the async
    reference == the sync port, request for request."""
    keys, ref, port = _pair(gamma=0.02)
    sync = ShardedIndexEngine(partition_bulkload(
        keys, payloads_for(keys), 3, cfg=AulidConfig(**SMALL_GEOM)),
        device="cpu", gamma=0.02, async_compact=False)
    rng = np.random.default_rng(7)
    trace = [_storm(keys, rng, 60), _storm(keys, rng, 10),
             _storm(keys, rng, 10), _storm(keys, rng, 40)]
    outs = [[], [], []]
    for i, step in enumerate(trace):
        for out, eng in zip(outs, (ref, port, sync)):
            out += _drive(eng, [step])
        check_served(ref.ov_arrs, port.ov_arrs)
        if i == 0:
            assert port.stats()["inflight"] == ref.stats()["inflight"] == 3
        if i >= 1:
            assert pools[0].pump() == pools[1].pump()
    ref.drain_compactions()
    port.drain_compactions()
    assert outs[0] == outs[1] == outs[2]
    _same_stats(ref, port)
    assert port.stats()["swaps"] >= 3
    assert port.stats()["compactions"] == sync.stats()["compactions"]


# -------------------------------------------------------------- repartition
def test_hot_key_updates_keep_the_fill_bound_at_the_live_count():
    """As the monolithic engine's test: updates of the same keys in every
    shard keep the merged pack's fill bound at the shards' entry count."""
    keys, ref, port = _pair(gamma=0.5, overlay_merge=True)
    hot = [int(k) for k in keys[::37][:40]]
    for s in range(12):
        _both(ref, port, [("insert", k, s * 1000 + i)
                          for i, k in enumerate(hot)]
              + [("get", hot[s]), ("scan", hot[0], 0, 7)])
    assert port.stats()["overlay_merges"] >= 10
    live = sum(len(sh.overlay) for sh in port.shards)
    assert port.ov_arrs["ov_fill"] == live == len(hot)
    assert port.ov_arrs["ov_spare"][1] == len(hot)


def _repart_pair(**kw):
    kw.setdefault("split_ratio", 1e9)     # policy off: tests force explicitly
    kw.setdefault("min_split_items", 16)
    return _pair(repartition=True, **kw)


def _both(ref, port, reqs):
    a, b = _drive(ref, [reqs]), _drive(port, [reqs])
    assert a == b
    check_served(ref.ov_arrs, port.ov_arrs)
    return b


def test_forced_split_and_merge_lifecycles(pools):
    """A split, then a merge, each frozen -> built in the background ->
    installed, with reads and writes in the in-flight window."""
    keys, ref, port = _repart_pair()
    s = max(range(port.num_shards), key=lambda i: port.shards[i].idx.n_items)
    assert ref.request_split(s) and port.request_split(s)
    assert not port.request_split(s), "one repartition in flight at a time"
    lo = 0 if s == 0 else int(port.part.bounds[s - 1]) + 1
    _both(ref, port, [("insert", lo + 3, 77), ("delete", int(keys[5])),
                      ("get", lo + 3), ("get", int(keys[5])),
                      ("scan", int(keys[0]), 0, 16)])
    assert pools[0].pump() == pools[1].pump() == 1
    _both(ref, port, [("get", lo + 3), ("get", int(keys[5])),
                      ("scan", int(keys[2]), 0, 16)])
    _same_stats(ref, port)
    assert port.splits == 1 and port.stk["bounds_version"] == 1
    assert ref.request_merge(0) and port.request_merge(0)
    _both(ref, port, [("insert", int(keys[1]) + 1, 5),
                      ("get", int(keys[1])), ("scan", int(keys[0]), 0, 16)])
    pools[0].pump()
    pools[1].pump()
    _both(ref, port, [("get", int(keys[1]) + 1), ("get", int(keys[-1])),
                      ("scan", int(port.part.bounds[0]) - 3, 0, 16)])
    _same_stats(ref, port)
    assert port.merges == 1 and port.part.version == 2
    assert np.array_equal(port.part.bounds, ref.part.bounds)
    assert port.part.pinned_versions() == {}


def test_failed_split_build_leaves_old_version_live(pools):
    keys, ref, port = _repart_pair()
    bounds0 = port.part.bounds.copy()

    def boom(s, split_key, sdi, epoch):
        raise RuntimeError("injected split-build failure")
    ref._split_job = boom
    port._split_job = boom
    assert ref.request_split(0) and port.request_split(0)
    _both(ref, port, [("insert", int(keys[2]) + 1, 91),
                      ("delete", int(keys[3])), ("get", int(keys[3]))])
    assert port.shards[0].pending, "window writes must defer"
    pools[0].pump()
    pools[1].pump()
    del ref._split_job, port._split_job
    _both(ref, port, [("get", int(keys[2]) + 1), ("get", int(keys[3])),
                      ("scan", int(keys[0]), 0, 16)])
    st = port.stats()
    assert st["repart_failures"] == 1 and st["splits"] == 0
    assert port.part.version == 0 and np.array_equal(port.part.bounds,
                                                     bounds0)
    assert not port.shards[0].pending and port.part.pinned_versions() == {}
    _same_stats(ref, port)
    # the retry lands
    assert ref.request_split(0) and port.request_split(0)
    pools[0].pump()
    pools[1].pump()
    _both(ref, port, [("get", int(k)) for k in keys[:8]])
    assert port.splits == 1 and port.part.version == 1
    _same_stats(ref, port)


def test_sync_repartition_matches_async(pools):
    """Splits forced every step, inline (sync) and in the background
    (async, pumped by hand): equal answers to each other and to the
    reference's async engine."""
    keys, ref, dbuf = _repart_pair()
    sync = ShardedIndexEngine(partition_bulkload(
        keys, payloads_for(keys), 3, cfg=AulidConfig(**SMALL_GEOM)),
        device="cpu", repartition=True, split_ratio=1e9,
        min_split_items=16, async_compact=False)
    rng = np.random.default_rng(9)
    lo, hi = int(keys[0]), int(keys[-1])
    uni = np.unique(np.concatenate([keys[::9], np.linspace(
        lo + 7, hi + (hi - lo) // 4, 100).astype(np.uint64)]))
    outs = [[], [], []]
    for _ in range(4):
        step = []
        for _ in range(10):
            kind = int(rng.choice(4, p=[0.4, 0.4, 0.1, 0.1]))
            k = int(uni[int(rng.integers(0, len(uni)))])
            step.append([("get", k), ("insert", k, int(rng.integers(
                1, 2**31))), ("delete", k), ("scan", k, 0, 12)][kind])
        for out, eng in zip(outs, (ref, dbuf, sync)):
            out += _drive(eng, [step])
        pools[0].pump()
        pools[1].pump()
        for eng in (ref, dbuf, sync):
            eng.drain_compactions()
            sizes = [sh.idx.n_items for sh in eng.shards]
            eng.request_split(max(range(len(sizes)),
                                  key=sizes.__getitem__))
    pools[0].pump()
    pools[1].pump()
    sweep = [("get", int(k)) for k in uni[:64]]
    for out, eng in zip(outs, (ref, dbuf, sync)):
        eng.drain_compactions()
        out += _drive(eng, [sweep])
    assert outs[0] == outs[1] == outs[2]
    _same_stats(ref, dbuf)
    assert sync.splits == dbuf.splits >= 1
    assert np.array_equal(sync.part.bounds, dbuf.part.bounds)


def test_policy_splits_under_drift_like_reference():
    """The load monitor, sampled each step, splits the shard that drift
    inserts feed (sync builds), as the reference does."""
    keys, ref, port = _repart_pair(split_ratio=1.5, async_compact=False)
    top = int(keys[-1])
    rng = np.random.default_rng(4)
    trace = []
    for i in range(2):
        fresh = top + 1 + rng.choice(2**40, 400, replace=False)
        trace.append([("insert", int(k), i) for k in fresh]
                     + [("get", int(k)) for k in fresh[:10]]
                     + [("scan", int(keys[-5]), 0, 16)])
    assert _drive(port, trace) == _drive(ref, trace)
    _same_stats(ref, port)
    assert port.splits >= 1 and port.num_shards > 3
