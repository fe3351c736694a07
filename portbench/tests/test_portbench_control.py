"""A sound run of every cell is correct; its control and each fault the
cell can have (planted under the timed path, the run otherwise whole) are
not."""
import numpy as np
import pytest
import torch

from portbench import check, control
from portbench.tests.small import (cells, run_cell, sharded_cell,
                                   small_cell)

# "sharded": the harness's sharded engine under writes skewed to one shard
# and scans across shard bounds (small.py), no cell of BENCHMARK.json
WRITES = ["covid-200M.w4-read-heavy", "sharded"]
GETS = WRITES + ["covid-200M.w1-lookup"]
SCANS = ["covid-200M.w2-scan", "sharded"]
ALL = cells() + ["sharded"]


def _cell(name):
    return sharded_cell() if name == "sharded" else small_cell(name)


def run_small(name, trace=False):
    return run_cell(_cell(name), trace=trace)


@pytest.mark.parametrize("name", ALL)
def test_sound_run_is_correct(name):
    out = run_small(name)
    assert out["counts"] == {k: 0 for k in check.LIMITS}, out["counts"]
    assert out["failed"] == 0 and out["steps"] == 3
    assert out["metrics"]["ops_per_s"]["value"] > 0


@pytest.mark.parametrize("name", ALL)
def test_control_is_not_correct(name):
    counts = control.control_counts(_cell(name), 2**31 + 9, 3, "cpu")
    assert not check.correct(counts), counts


@pytest.mark.parametrize("name", WRITES)
def test_state_left_unchanged_is_caught(name, monkeypatch):
    """Writes acknowledged as the view would, but never applied."""
    from repro_torch.serving.index_engine import IndexShard
    monkeypatch.setattr(IndexShard, "apply_write",
                        lambda self, op, key, payload=0: op == "insert"
                        or self.idx.lookup(key) is not None)
    assert not check.correct(run_small(name)["counts"])


@pytest.mark.parametrize("name", ALL)
def test_half_the_batch_left_out_is_caught(name, monkeypatch):
    """The engine serves the first half of its reads and drops the rest."""
    from repro_torch.serving.index_engine import BaseIndexEngine
    for attr in ("_serve_gets", "_serve_scans"):
        orig = getattr(BaseIndexEngine, attr)
        monkeypatch.setattr(BaseIndexEngine, attr,
                            lambda self, rs, orig=orig:
                            orig(self, rs[:max(len(rs) // 2, 1)]))
    counts = run_small(name)["counts"]
    assert counts["unanswered"] > 0 and not check.correct(counts)


def _altered(fn, field):
    """``fn`` with the first entry of each row of its output ``field``
    (a get's payload; a scan's first row payload) one off."""
    def run(*a, **kw):
        out = list(fn(*a, **kw))
        t = out[field].clone()
        if t.dim() == 1:
            t[0] += 1
        else:
            t[:, 0] += 1
        out[field] = t
        return tuple(out)
    return run


@pytest.mark.parametrize("name", GETS)
def test_get_answer_altered_is_caught(name, monkeypatch):
    from repro_torch.serving import index_engine, sharded_engine
    for mod, fn in ((index_engine, "lookup_batch_overlay"),
                    (sharded_engine, "lookup_batch_sharded_overlay")):
        monkeypatch.setattr(mod, fn, _altered(getattr(mod, fn), 0))
    counts = run_small(name)["counts"]
    assert counts["gets_wrong"] > 0 and not check.correct(counts)


@pytest.mark.parametrize("name", SCANS)
def test_scan_row_altered_is_caught(name, monkeypatch):
    from repro_torch.serving import index_engine, sharded_engine
    for mod, fn in ((index_engine, "scan_batch_overlay"),
                    (sharded_engine, "scan_batch_sharded_overlay")):
        monkeypatch.setattr(mod, fn, _altered(getattr(mod, fn), 1))
    counts = run_small(name)["counts"]
    assert counts["scans_wrong"] > 0 and not check.correct(counts)


def test_traced_run_reads_its_phases():
    out = run_small("sharded", trace=True)
    tr = out["trace"]
    assert tr["steps"] == 3 and tr["latency_s"].size == 3 * 8720
    assert all(tr["phase_calls"][p] for p in ("overlay_merge", "gets",
                                              "scans"))
    assert tr["k1_launches"] == 6 and tr["k1_bound_s"] > 0
    assert tr["device"] is None            # no card: no device reading
    assert np.all(tr["latency_s"] > 0) and torch.get_num_threads() >= 1
