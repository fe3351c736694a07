"""The index engines' tracer (``repro_torch.serving.tracing``).

On, it changes no answer and no counter of ``stats()`` (twin engines over
the equivalence tests' mixed traces, one traced); its spans nest, carry
names of the fixed set, and their ``step`` spans' request ids cover every
submitted request once; off, nothing is kept and ``submit`` is the
class's own.  The host index's walk counters equal hand counts on a small
``Aulid`` with a known NULL run, and the write spans' block reads equal
the ``BlockDevice``'s own counts.
"""
import numpy as np
import pytest

import test_torch_engine as te
import test_torch_sharded_engine as tse

from repro_torch.core import (Aulid, AulidConfig, BlockDevice,
                              partition_bulkload)
from repro_torch.core.aulid import TAG_NULL
from repro_torch.core.workloads import make_dataset, payloads_for
from repro_torch.serving import IndexEngine, ShardedIndexEngine
from repro_torch.serving import tracing
from repro_torch.serving.index_engine import BaseIndexEngine

SMALL = AulidConfig(**te.SMALL_GEOM)


def _index_engine(n=1_500, **kw):
    keys = make_dataset("covid", n, seed=1)
    idx = Aulid(BlockDevice(), cfg=AulidConfig(**te.SMALL_GEOM))
    idx.bulkload(keys, payloads_for(keys))
    return keys, IndexEngine(idx, device="cpu", **kw)


def _sharded_engine(n=1_500, **kw):
    keys = make_dataset("covid", n, seed=1)
    part = partition_bulkload(keys, payloads_for(keys), 3,
                              cfg=AulidConfig(**te.SMALL_GEOM))
    return keys, ShardedIndexEngine(part, device="cpu", **kw)


CASES = {
    "index-merge": (lambda: _index_engine(gamma=0.02),
                    lambda k: te._trace(k, seed=3, steps=4), te.STAT_KEYS),
    "index-reseed": (lambda: _index_engine(gamma=0.02, overlay_merge=False),
                     lambda k: te._trace(k, seed=5, steps=4), te.STAT_KEYS),
    "sharded": (lambda: _sharded_engine(gamma=0.02, async_compact=False),
                lambda k: tse._trace(k, seed=11, steps=4), tse.STAT_KEYS),
}


def _traced(case):
    make, trace_of, _ = CASES[case]
    keys, eng = make()
    trace = trace_of(keys)
    eng.start_trace()
    out = te._drive(eng, trace)
    return eng, eng.stop_trace().export(), out, trace


def _stamped_rids(n: int) -> np.ndarray:
    """The request ids (from 0) that the stamped submit stamps among n."""
    gaps = np.tile(tracing.STAMP_GAPS, n // len(tracing.STAMP_GAPS) + 1)
    rids = np.cumsum(gaps) - 1
    return rids[rids < n]


def test_stamp_gaps_average_stamp_every():
    gaps = np.asarray(tracing.STAMP_GAPS)
    assert gaps.min() >= 1 and gaps.max() <= 2 * tracing.STAMP_EVERY - 1
    assert abs(gaps.mean() - tracing.STAMP_EVERY) < 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_tracer_changes_no_answer_and_no_counter(case):
    make, trace_of, stat_keys = CASES[case]
    keys, plain = make()
    eng, exp, got, trace = _traced(case)
    assert got == te._drive(plain, trace)
    a, b = plain.stats(), eng.stats()
    assert {k: a[k] for k in stat_keys} == {k: b[k] for k in stat_keys}
    assert b["compactions"] >= 1
    n = sum(len(s) for s in trace)
    assert exp["admitted"] == _stamped_rids(n).size > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_nest_and_their_steps_cover_every_request(case):
    eng, exp, _, trace = _traced(case)
    sp = exp["spans"]
    names = [exp["names"][c] for c in sp["name"]]
    assert set(names) <= set(tracing.SPANS)
    assert (sp["end_ns"] >= sp["start_ns"]).all()
    for i, p in enumerate(sp["parent"].tolist()):
        if p < 0:
            assert names[i] == "step"
            continue
        assert sp["start_ns"][p] <= sp["start_ns"][i]
        assert sp["end_ns"][i] <= sp["end_ns"][p]
        assert sp["step"][i] == sp["step"][p]
    steps = tracing.span_mask(exp, "step")
    assert steps.sum() == len(trace)
    assert sp["step"][steps].tolist() == list(range(len(trace)))
    first, last = exp["counters"]["rid_first"], exp["counters"]["rid_last"]
    assert first["span"].tolist() == np.flatnonzero(steps).tolist()
    rids = np.concatenate([np.arange(a, b + 1) for a, b in
                           zip(first["value"], last["value"])])
    assert rids.tolist() == list(range(sum(len(s) for s in trace)))
    assert exp["submit"]["rid"].tolist() == _stamped_rids(rids.size).tolist()
    sub = exp["submit"]
    assert (sub["end_ns"] >= sub["start_ns"]).all()
    assert exp["admission_ns"] == (sub["end_ns"] - sub["start_ns"]).sum()
    for phase in ("writes.host", "writes.after", "gets", "scans"):
        assert tracing.span_mask(exp, phase).any(), phase
    # the engine's compaction and the merge or reseed after its writes
    inner = {"compact", "overlay.merge", "overlay.reseed"} & set(names)
    assert inner if case.startswith("index") else not inner
    lat, wait = tracing.request_times(exp)
    assert lat.size == exp["admitted"] > 0
    assert (lat >= wait).all() and (wait >= 0).all()


def test_counters_sum_to_the_step_counts():
    eng, exp, _, trace = _traced("index-merge")
    writes = sum(r[0] in ("insert", "delete") for s in trace for r in s)
    assert tracing.counter_total(exp, "writes", "writes.host") == writes
    assert tracing.counter_total(exp, "writes", "step") == writes
    gets = sum(r[0] == "get" for s in trace for r in s)
    assert tracing.counter_total(exp, "gets", "step") == gets
    scans = sum(r[0] == "scan" for s in trace for r in s)
    assert tracing.counter_total(exp, "scans", "step") == scans
    assert eng.stats()["overlay_merges"] > 0
    # the engine's own totals are not repeated on the spans
    for counter, name in (("merges", "writes.after"), ("swaps", "step.begin"),
                          ("queries", "gets"), ("bucket", "scans"),
                          ("no_such_counter", "gets")):
        assert tracing.counter_total(exp, counter, name) is None, counter


def test_collections_are_kept_while_tracing():
    import gc
    keys, eng = _index_engine()
    n = len(gc.callbacks)
    tr = eng.start_trace()
    assert len(gc.callbacks) == n + 1
    gc.collect()
    te._drive(eng, te._trace(keys, seed=5, steps=1))
    eng.stop_trace()
    assert len(gc.callbacks) == n
    gc.collect()
    g = tr.export()["gc"]
    assert g["generation"].size >= 1 and 2 in g["generation"].tolist()
    assert (g["end_ns"] >= g["start_ns"]).all()
    assert (g["start_ns"][1:] >= g["end_ns"][:-1]).all()
    assert tr.start_ns <= g["start_ns"][0] and g["end_ns"][-1] <= tr.stop_ns


def test_off_keeps_nothing_and_submit_is_the_classs():
    keys, eng = _index_engine()
    assert eng.tracer is None and eng.shard.tracer is None
    assert "submit" not in eng.__dict__
    assert eng.submit.__func__ is BaseIndexEngine.submit
    tr = eng.start_trace()
    assert eng.tracer is tr and eng.shard.tracer is tr
    assert "submit" in eng.__dict__
    with pytest.raises(RuntimeError):
        eng.start_trace()
    te._drive(eng, te._trace(keys, seed=3, steps=1))
    assert eng.stop_trace() is tr
    n = len(tr.export()["spans"]["name"])
    assert eng.tracer is None and eng.shard.tracer is None
    assert "submit" not in eng.__dict__
    assert eng.submit.__func__ is BaseIndexEngine.submit
    te._drive(eng, te._trace(keys, seed=4, steps=2))
    exp = tr.export()
    assert len(exp["spans"]["name"]) == n and n > 0
    assert len(exp["anchor_ns"]) == tracing.ANCHOR_TAKES
    assert exp["anchor_ns"] == sorted(exp["anchor_ns"])
    assert exp["start_ns"] <= exp["anchor_ns"][0]
    assert exp["anchor_ns"][-1] <= exp["stop_ns"]
    with pytest.raises(RuntimeError):
        eng.stop_trace()


def _null_run_index():
    """Two clusters of 64 keys: the root's 64 slots hold a packed array at
    0, a NULL run over 1-61, a packed array at 62 and a data slot at 63."""
    keys = np.concatenate([np.arange(1000, 1640, 10),
                           np.arange(100_000, 100_640, 10)]).astype(np.uint64)
    idx = Aulid(BlockDevice(), cfg=SMALL)
    idx.bulkload(keys, keys + np.uint64(1))
    return idx


def test_null_scan_and_walk_counts_equal_hand_counts():
    idx = _null_run_index()
    root = idx.root
    new_key, old_key = 50_000, 1010
    slot = root.predict(new_key)
    # the run the forward scan crosses: from the predicted slot to the
    # next occupied one, every slot after it examined by the scan
    run_end = slot + int(np.flatnonzero(root.tags[slot:] != TAG_NULL)[0])
    assert root.fanout == 64 and slot == 30 and run_end == 62
    assert (root.tags[slot:run_end] == TAG_NULL).all()
    assert root.tags[root.predict(old_key)] != TAG_NULL
    assert new_key < idx.last_leaf_min and old_key < idx.last_leaf_min
    eng = IndexEngine(idx, device="cpu", gamma=0.5)
    eng.start_trace()
    eng.insert(new_key, 7)          # a new key: update misses, insert walks
    eng.step()
    eng.insert(old_key, 8)          # an update: one walk
    eng.step()
    exp = eng.stop_trace().export()
    c = exp["counters"]
    host = tracing.span_mask(exp, "writes.host")
    at = {k: c[k]["value"][host[c[k]["span"]]].tolist()
          for k in ("leaf_walks", "null_scans", "null_scan_slots")}
    assert at == {"leaf_walks": [2, 1], "null_scans": [2, 0],
                  "null_scan_slots": [2 * (root.fanout - slot), 0]}
    assert idx.lookup(new_key) == 7 and idx.lookup(old_key) == 8


def test_write_span_block_reads_equal_the_devices_counts():
    keys, eng = _index_engine(gamma=0.5)
    dev = eng.idx.dev
    trace = te._trace(keys, seed=9, steps=3)
    eng.start_trace()
    before, walks = dev.stats.snapshot(), eng.idx.leaf_walks
    te._drive(eng, trace)
    diff = dev.stats.delta(before)
    exp = eng.stop_trace().export()
    # no compaction, and reads served from the mirror: every host block
    # access of the steps is a write's
    assert eng.stats()["compactions"] == 0
    assert diff.reads > 0 and diff.writes > 0
    assert tracing.counter_total(exp, "block_reads", "writes.host") == \
        diff.reads
    assert tracing.counter_total(exp, "block_writes", "writes.host") == \
        diff.writes
    assert tracing.counter_total(exp, "leaf_walks", "writes.host") == \
        eng.idx.leaf_walks - walks
