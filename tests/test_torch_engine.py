"""The port's ``IndexEngine`` == the reference's, request for request.

Twin engines over the same bulkloaded keys serve the same seeded mixed
traces (inserts of new keys, updates, deletes of live and dead keys, gets
of present/absent/just-written keys, scans of mixed lengths): the port on
the CPU (its kernels' plain versions), the reference on its jnp path.
Every result must be equal, across synchronous compaction, background
compaction pumped by hand (the in-flight window spans whole steps), and the
overlay merge on and off; so must the write-path counters of ``stats()``.
"""
import numpy as np
import pytest

pytest.importorskip("jax")   # the reference; absent where only the port runs

from test_async_compaction import ManualExecutor

from repro.core import Aulid as RefAulid, AulidConfig as RefConfig
from repro.core import BlockDevice as RefBlockDevice
from repro.core.workloads import make_dataset, payloads_for
from repro.serving import IndexEngine as RefEngine
from repro.serving import index_engine as ref_ie

from repro_torch.core import Aulid, AulidConfig, BlockDevice
from repro_torch.serving import IndexEngine
from repro_torch.serving import index_engine as port_ie

SMALL_GEOM = dict(leaf_capacity=16, pa_classes=(4, 8), bt_child_capacity=15)
STAT_KEYS = ("compactions", "overlay_merges", "overlay_reseeds",
             "write_h2d_bytes", "swaps", "failed_swaps", "steps",
             "reads_served", "writes_applied", "overlay_len",
             "mirror_refreshes", "mirror_full_builds")


def _pair(n=1_500, seed=1, **kw):
    keys = make_dataset("covid", n, seed=seed)
    pays = payloads_for(keys)
    ref_idx = RefAulid(RefBlockDevice(), cfg=RefConfig(**SMALL_GEOM))
    ref_idx.bulkload(keys, pays)
    idx = Aulid(BlockDevice(), cfg=AulidConfig(**SMALL_GEOM))
    idx.bulkload(keys, pays)
    return (keys, RefEngine(ref_idx, backend="jnp", **kw),
            IndexEngine(idx, device="cpu", **kw))


def _trace(keys, seed, steps, writes=24, gets=40, scans=3):
    """Per step: new-key inserts, updates, deletes (some of dead keys),
    gets of snapshot / fresh / absent keys, scans of mixed lengths."""
    rng = np.random.default_rng(seed)
    fresh_all, out = [], []
    for _ in range(steps):
        step = []
        fresh = [int(k) for k in rng.integers(1, 2**48, writes // 2,
                                               dtype=np.uint64)]
        fresh_all += fresh
        step += [("insert", k, k % 997) for k in fresh]
        step += [("insert", int(k), 5) for k in rng.choice(keys, writes // 4)]
        step += [("delete", int(k)) for k in rng.choice(keys, writes // 4)]
        if fresh_all:
            step += [("delete", int(rng.choice(fresh_all)))]
        step += [("get", int(k)) for k in rng.choice(keys, gets // 2)]
        step += [("get", int(k)) for k in rng.choice(fresh_all, gets // 4)]
        step += [("get", int(k)) for k in rng.integers(0, 2**62, gets // 4,
                                                       dtype=np.uint64)]
        step += [("scan", int(k), 0, int(c)) for k, c in zip(
            rng.choice(keys, scans), rng.choice([5, 7], scans))]
        out.append(step)
    return out


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


@pytest.mark.parametrize("overlay_merge", [True, False],
                         ids=["merge", "reseed"])
def test_sync_compaction_stream(overlay_merge):
    keys, ref, port = _pair(gamma=0.02, overlay_merge=overlay_merge)
    trace = _trace(keys, seed=3, steps=4)
    assert _drive(ref, trace) == _drive(port, trace)
    _same_stats(ref, port)
    st = port.stats()
    assert st["compactions"] >= 2 and st["read_backend"] == "torch"
    assert (st["overlay_merges"] > 0) == overlay_merge


def test_no_compaction_long_overlay():
    """gamma high enough that the overlay only grows: every step takes the
    device merge path, scans merge a filling overlay."""
    keys, ref, port = _pair(gamma=0.5)
    trace = _trace(keys, seed=8, steps=4, writes=40)
    assert _drive(ref, trace) == _drive(port, trace)
    _same_stats(ref, port)
    assert port.stats()["compactions"] == 0


@pytest.mark.parametrize("overlay_merge", [True, False],
                         ids=["merge", "reseed"])
def test_async_compaction_hand_pumped(monkeypatch, overlay_merge):
    pools = ManualExecutor(), ManualExecutor()
    monkeypatch.setattr(ref_ie, "_COMPACT_POOL", pools[0])
    monkeypatch.setattr(port_ie, "_COMPACT_POOL", pools[1])
    keys, ref, port = _pair(gamma=0.02, async_compact=True,
                            overlay_merge=overlay_merge)
    trace = _trace(keys, seed=5, steps=5)
    # storm (freezes), in-flight steps, then the swap and steps after it
    assert _drive(ref, trace[:3]) == _drive(port, trace[:3])
    assert port.stats()["inflight"] == ref.stats()["inflight"] == 1
    assert port.shard.frozen_overlay is not None and port.shard.pending
    _same_stats(ref, port)
    assert pools[0].pump() == pools[1].pump() == 1
    assert _drive(ref, trace[3:]) == _drive(port, trace[3:])
    for p in pools:
        p.pump()
    ref.drain_compactions()
    port.drain_compactions()
    _same_stats(ref, port)
    assert port.stats()["swaps"] >= 1


def test_failed_build_keeps_writes(monkeypatch):
    pools = ManualExecutor(), ManualExecutor()
    monkeypatch.setattr(ref_ie, "_COMPACT_POOL", pools[0])
    monkeypatch.setattr(port_ie, "_COMPACT_POOL", pools[1])
    keys, ref, port = _pair(gamma=0.02, async_compact=True)
    trace = _trace(keys, seed=9, steps=4)

    def boom():
        raise RuntimeError("injected build failure")
    ref._build_job = boom
    port._build_job = boom
    assert _drive(ref, trace[:2]) == _drive(port, trace[:2])
    del ref._build_job, port._build_job
    for p in pools:
        p.pump()
    assert _drive(ref, trace[2:]) == _drive(port, trace[2:])
    _same_stats(ref, port)
    assert port.stats()["failed_swaps"] == 1
