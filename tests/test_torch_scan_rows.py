"""A scan's answer as two owned uint64 columns (``serving.ScanRows``).

The type: equal to the list of ``(key, payload)`` pairs it stands for,
and to nothing looser; a ``Sequence`` of tuples of Python ints, exact
above 2**63.  The engines: ``IndexEngine`` and ``ShardedIndexEngine`` on
the CPU answer scans with ``ScanRows`` equal to the reference's lists,
over same-step overlay inserts and tombstones; each answer owns its rows
(no memory shared with the scan batch's fetched arrays); the tracer's
``rows`` counter on ``scans.pairs`` counts the rows handed out.
"""
import numpy as np
import pytest

from repro_torch.core import Aulid, AulidConfig, BlockDevice
from repro_torch.core.workloads import make_dataset, payloads_for
from repro_torch.serving import IndexEngine, ScanRows
from repro_torch.serving import index_engine as port_ie
from repro_torch.serving import tracing

PAIRS = [(3, 30), (5, 2**64 - 1), (2**63 + 7, 9)]


def _rows(pairs):
    return ScanRows(np.array([k for k, _ in pairs], np.uint64),
                    np.array([p for _, p in pairs], np.uint64))


# ------------------------------------------------------------------ the type
@pytest.mark.parametrize("form", [list, tuple], ids=["list", "tuple"])
def test_equals_the_pairs_it_stands_for(form):
    r = _rows(PAIRS)
    assert r == form(PAIRS) and form(PAIRS) == r
    assert not (r != form(PAIRS)) and not (form(PAIRS) != r)
    assert r == _rows(PAIRS) and not (r != _rows(PAIRS))
    assert [(1, r)] == [(1, form(PAIRS))]


UNEQUAL = {
    "shorter": PAIRS[:-1],
    "longer": PAIRS + [(2**64 - 2, 1)],
    "one-key": [PAIRS[0], (6, PAIRS[1][1]), PAIRS[2]],
    "one-payload": [PAIRS[0], (PAIRS[1][0], 2**64 - 2), PAIRS[2]],
    "order": [PAIRS[1], PAIRS[0], PAIRS[2]],
    "pair-as-list": [PAIRS[0], list(PAIRS[1]), PAIRS[2]],
    "none": None,
    "int": 3,
}


@pytest.mark.parametrize("case", list(UNEQUAL))
def test_differs_from_anything_else(case):
    r, other = _rows(PAIRS), UNEQUAL[case]
    assert r != other and other != r
    assert not (r == other) and not (other == r)
    if isinstance(other, list) and all(isinstance(p, tuple) for p in other):
        assert r != _rows(other) and not (r == _rows(other))


def test_a_sequence_of_python_int_pairs():
    r = _rows(PAIRS)
    assert len(r) == 3
    assert r[0] == PAIRS[0] and r[-1] == PAIRS[2] and r[-3] == PAIRS[0]
    assert r[np.int64(1)] == PAIRS[1]
    with pytest.raises(IndexError):
        r[3]
    assert r[1:] == PAIRS[1:] and r[::-1] == PAIRS[::-1] and r[5:] == []
    assert isinstance(r[1:], list)
    assert list(r) == PAIRS and list(reversed(r)) == PAIRS[::-1]
    assert PAIRS[1] in r and (5, 6) not in r and [3, 30] not in r
    assert r.index(PAIRS[2]) == 2 and r.count(PAIRS[0]) == 1
    assert repr(r) == repr(PAIRS)
    with pytest.raises(TypeError):
        hash(r)
    assert not hasattr(r, "__dict__")


def test_values_above_2_63_are_exact_python_ints():
    r = _rows([(2**64 - 2, 2**64 - 1), (2**63, 2**63 + 1)])
    for pair in (r[0], r[1], *r, *r[:]):
        assert all(type(v) is int for v in pair)
    assert list(r) == [(2**64 - 2, 2**64 - 1), (2**63, 2**63 + 1)]


def test_empty_equals_the_empty_list():
    r = ScanRows(np.zeros(0, np.uint64), np.zeros(0, np.uint64))
    assert r == [] and r == () and len(r) == 0 and list(r) == []
    assert r != [(1, 2)] and repr(r) == "[]"


# --------------------------------------------------------------- the engines
SMALL_GEOM = dict(leaf_capacity=16, pa_classes=(4, 8), bt_child_capacity=15)


def _engine(keys, **kw):
    idx = Aulid(BlockDevice(), cfg=AulidConfig(**SMALL_GEOM))
    idx.bulkload(keys, payloads_for(keys))
    return IndexEngine(idx, device="cpu", **kw)


def _scan_steps(keys):
    """Two steps of same-step writes (fresh keys between bulkloaded ones,
    tombstones, overwrites) and scans over them: counts 1, 7, 100 and 200,
    from below the first key, across the writes, into the tail, and from
    past the last key (empty; then one row once a key is written there)."""
    ks = [int(k) for k in keys]
    have = set(ks)
    fresh = [k + 1 for k in ks[80:140:6] if k + 1 not in have]
    last = ks[-1]
    step1 = ([("insert", k, k % 991) for k in fresh]
             + [("delete", k) for k in ks[195:206]]
             + [("insert", k, 7) for k in ks[60:64]]
             + [("scan", ks[98], 0, 1), ("scan", ks[190], 0, 7),
                ("scan", ks[79], 0, 100), ("scan", ks[40], 0, 200),
                ("scan", 0, 0, 7), ("scan", ks[-5], 0, 100),
                ("scan", last + 1, 0, 100), ("scan", ks[200], 0, 1)])
    step2 = ([("delete", k) for k in fresh[::2]]
             + [("insert", last + 5, 2**64 - 7), ("delete", ks[-2])]
             + [("scan", ks[79], 0, 100), ("scan", ks[190], 0, 200),
                ("scan", last + 1, 0, 7), ("scan", ks[-3], 0, 1)])
    return [step1, step2]


def _reference():
    pytest.importorskip("jax")
    import test_torch_engine as te
    return te


def test_index_engine_scans_match_the_reference():
    te = _reference()
    keys, ref, port = te._pair(gamma=0.5)
    trace = _scan_steps(keys)
    got = te._lockstep(ref, port, trace)
    scans = [res for op, _, res in got if op == "scan"]
    assert all(isinstance(r, ScanRows) for r in scans)
    assert [len(r) for r in scans] == [1, 7, 100, 200, 7, 5, 0, 1,
                                       100, 200, 1, 1]
    last = int(keys[-1])
    assert scans[-2] == [(last + 5, 2**64 - 7)]
    assert port.stats()["compactions"] == 0 and port._overlay_live() > 0


def test_a_full_step_of_scans_of_100_matches_the_reference():
    """The benchmark's w2 shape on a small index: 8,192 scans of 100 in
    one step, over writes of the same step."""
    te = _reference()
    keys, ref, port = te._pair(n=3_000, gamma=0.5)
    rng = np.random.default_rng(4)
    step = ([("insert", int(k), int(k) % 97)
             for k in rng.integers(1, 2**48, 40, dtype=np.uint64)]
            + [("delete", int(k)) for k in rng.choice(keys, 20)]
            + [("scan", int(k), 0, 100) for k in rng.choice(keys, 8192)])
    got = te._lockstep(ref, port, [step])
    scans = [res for op, _, res in got if op == "scan"]
    assert len(scans) == 8192 and all(isinstance(r, ScanRows) for r in scans)


def test_sharded_engine_scan_across_a_boundary_matches_the_reference():
    _reference()
    import test_torch_sharded_engine as tse
    keys, ref, port = tse._pair()
    b = int(port.part.bounds[0])
    i = int(np.searchsorted(keys, np.uint64(b)))
    step = [("insert", b + 1, 222), ("delete", int(keys[i - 1])),
            ("scan", int(keys[i - 3]), 0, 7),
            ("scan", int(keys[i - 40]), 0, 100),
            ("scan", int(keys[-1]) + 1, 0, 7)]
    got = tse._drive(port, [step])
    assert got == tse._drive(ref, [step])
    rows = [res for op, _, res in got if op == "scan"]
    assert all(isinstance(r, ScanRows) for r in rows)
    assert [len(r) for r in rows] == [7, 100, 0]
    crossed = rows[1].keys
    assert crossed[0] <= b < crossed[-1] and b + 1 in crossed.tolist()


def test_answers_own_their_rows(monkeypatch):
    """No answer shares memory with the fetched (Q, bucket) arrays it was
    cut from, and each owns its arrays."""
    fetched = []

    def keep(f):
        def run(t):
            out = f(t)
            fetched.append(out)
            return out
        return run
    monkeypatch.setattr(port_ie, "keys_from_tensor",
                        keep(port_ie.keys_from_tensor))
    monkeypatch.setattr(port_ie, "bits_from_tensor",
                        keep(port_ie.bits_from_tensor))
    keys = make_dataset("covid", 1_500, seed=1)
    eng = _engine(keys, gamma=0.5)
    reqs = [eng.submit(*r) for r in _scan_steps(keys)[0]]
    eng.step()
    scans = [r.result for r in reqs if r.op == "scan"]
    assert len(fetched) == 2 * len({port_ie.scan_bucket(r.count)
                                    for r in reqs if r.op == "scan"})
    for r in scans:
        for col in (r.keys, r.payloads):
            assert col.dtype == np.uint64 and col.base is None
            assert not any(np.shares_memory(col, a) for a in fetched)


def _sharded(keys):
    from repro_torch.core import partition_bulkload
    from repro_torch.serving import ShardedIndexEngine
    return ShardedIndexEngine(partition_bulkload(
        keys, payloads_for(keys), 3, cfg=AulidConfig(**SMALL_GEOM)),
        device="cpu", gamma=0.5, async_compact=False)


@pytest.mark.parametrize("make", [lambda k: _engine(k, gamma=0.5), _sharded],
                         ids=["index", "sharded"])
def test_rows_counter_counts_the_rows_handed_out(make):
    keys = make_dataset("covid", 1_500, seed=1)
    eng = make(keys)
    eng.start_trace()
    answers = []
    for step in _scan_steps(keys):
        reqs = [eng.submit(*r) for r in step]
        eng.step()
        answers += [r.result for r in reqs if r.op == "scan"]
    exp = eng.stop_trace().export()
    rows = sum(len(r) for r in answers)
    assert rows > 0
    assert tracing.counter_total(exp, "rows", "scans.pairs") == rows
    # one value a bucket: each scans.pairs span carries it
    c = exp["counters"]["rows"]
    assert c["span"].tolist() == np.flatnonzero(
        tracing.span_mask(exp, "scans.pairs")).tolist()
