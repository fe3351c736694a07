"""``program_trace``: the program's spans on the profiler's clock and the
card's idle time by innermost span; and the untraced run never turns the
program's tracer on."""
import numpy as np
import pytest

from portbench import program_trace
from portbench.tests.small import run_small
from portbench.tests.test_portbench_run import _Ev, _Prof
from repro_torch.serving.tracing import ANCHOR, anchor_offset


def _export(spans):
    """A ``Tracer.export()`` holding ``spans``: (name, start, end, parent)."""
    from repro_torch.serving.tracing import SPANS
    return {"names": SPANS,
            "spans": {"name": np.array([SPANS.index(s[0]) for s in spans],
                                       np.int16),
                      "start_ns": np.array([s[1] for s in spans], np.int64),
                      "end_ns": np.array([s[2] for s in spans], np.int64),
                      "parent": np.array([s[3] for s in spans], np.int64),
                      "step": np.zeros(len(spans), np.int64)}}


# one step [100, 900): partition [100, 150), gets [200, 700) with its
# queries [200, 300), launch [300, 320), fetch [320, 600), fill [600, 700);
# a second step [1000, 1200) with nothing inside it
SPANS_1 = [("step", 100, 900, -1), ("step.partition", 100, 150, 0),
           ("gets", 200, 700, 0), ("gets.queries", 200, 300, 2),
           ("gets.launch", 300, 320, 2), ("gets.fetch", 320, 600, 2),
           ("gets.fill", 600, 700, 2), ("step", 1000, 1200, -1)]


def test_self_segments_follow_the_innermost_span():
    s, e, names = program_trace.self_segments(_export(SPANS_1))
    got = list(zip(s.tolist(), e.tolist(), names))
    assert got == [(100, 150, "step.partition"), (150, 200, "step"),
                   (200, 300, "gets.queries"), (300, 320, "gets.launch"),
                   (320, 600, "gets.fetch"), (600, 700, "gets.fill"),
                   (700, 900, "step"), (1000, 1200, "step")]


def test_collections_are_innermost_where_they_fall():
    exp = _export(SPANS_1)
    # one collection in the fill, one between the steps
    exp["gc"] = {"start_ns": np.array([620, 950], np.int64),
                 "end_ns": np.array([660, 980], np.int64),
                 "generation": np.array([0, 2], np.int64)}
    s, e, names = program_trace.self_segments(exp)
    got = list(zip(s.tolist(), e.tolist(), names))
    assert got[5:9] == [(600, 620, "gets.fill"), (620, 660, "gc"),
                        (660, 700, "gets.fill"), (700, 900, "step")]
    assert got[9:] == [(950, 980, "gc"), (1000, 1200, "step")]
    idle = program_trace.idle_by_span(exp, np.zeros(0, np.int64),
                                      np.zeros(0, np.int64), 0, 1250)
    assert round(idle["gc"] * 1e9) == 70
    assert round(idle["gets.fill"] * 1e9) == 60


def test_idle_by_span_splits_the_windows_idle_time():
    # the card busy over [310, 400) (inside launch and fetch) and
    # [1100, 1300) (half outside the second step, past the window's end)
    dev_s = np.array([310, 350, 1100], np.int64)
    dev_e = np.array([400, 380, 1300], np.int64)
    idle = program_trace.idle_by_span(_export(SPANS_1), dev_s, dev_e,
                                      0, 1250)
    ns = {k: round(v * 1e9) for k, v in idle.items()}
    assert ns == {"step.partition": 50, "step": 50 + 200 + 100,
                  "gets.queries": 100, "gets.launch": 10,
                  "gets.fetch": 280 - 80, "gets.fill": 100,
                  "outside_program": 100 + 100 + 0}
    assert list(idle) == sorted(idle, key=lambda k: -idle[k])
    busy = 90 + 150
    assert np.isclose(sum(idle.values()), (1250 - busy) / 1e9)


def test_device_intervals_move_onto_the_host_clock_by_the_anchor():
    off = 7_000                      # the profiler's clock runs 7 us ahead
    stamps = [50, 80]
    # the shorter anchor range's midpoint is its stamp's time on the
    # profiler's clock; the longer one's midpoint lies 6 ns off
    ev = [_Ev(ANCHOR, 50 + off - 900, 1812, cuda=False, annotation=True),
          _Ev(ANCHOR, 80 + off - 2, 4, cuda=False, annotation=True),
          _Ev("(anonymous namespace)::fused_lookup_kernel(x)", 300 + off,
              20),
          _Ev("Memcpy DtoH (Device -> Pageable)", 330 + off, 40),
          _Ev("gets", 200 + off, 500, annotation=True),
          _Ev(ANCHOR, 80 + off, 1)]
    s, e = program_trace.device_intervals(_Prof(ev), stamps)
    assert s.tolist() == [300, 330] and e.tolist() == [320, 370]
    assert anchor_offset(ev, stamps) == off
    assert anchor_offset(ev[:1], stamps[:1]) == off + 6
    with pytest.raises(RuntimeError):
        program_trace.device_intervals(_Prof(ev[2:]), stamps)
    with pytest.raises(RuntimeError):
        anchor_offset(ev, stamps[:1])


def test_a_cpu_engines_spans_cover_its_steps():
    """A real export (an engine on the CPU, no device intervals): the idle
    time by span adds up to the window, the steps' time to the spans'."""
    from repro_torch.core import Aulid, BlockDevice
    from repro_torch.core.workloads import make_dataset, payloads_for
    from repro_torch.serving import IndexEngine
    keys = make_dataset("covid", 5_000, seed=2)
    idx = Aulid(BlockDevice())
    idx.bulkload(keys, payloads_for(keys))
    eng = IndexEngine(idx, device="cpu")
    rng = np.random.default_rng(4)
    tr = eng.start_trace()
    for _ in range(3):
        for k in rng.integers(1, 2**40, 20, dtype=np.uint64):
            eng.insert(int(k), 1)
        for k in rng.choice(keys, 200):
            eng.get(int(k))
        eng.scan(int(keys[7]), 20)
        eng.step()
    exp = eng.stop_trace().export()
    none = np.zeros(0, np.int64)
    t0, t1 = exp["start_ns"], exp["stop_ns"]
    idle = program_trace.idle_by_span(exp, none, none, t0, t1)
    assert np.isclose(sum(idle.values()), (t1 - t0) / 1e9)
    sp = exp["spans"]
    steps = sp["name"] == 0
    # collections count where they fall, inside a step or between steps
    g = exp["gc"]
    gc_in_steps = sum(
        int(b - a) for a, b in zip(g["start_ns"], g["end_ns"])
        if ((sp["start_ns"][steps] <= a) & (b <= sp["end_ns"][steps])).any())
    in_steps = sum(v for k, v in idle.items()
                   if k not in ("outside_program", "gc")) + gc_in_steps / 1e9
    assert np.isclose(in_steps,
                      (sp["end_ns"][steps] - sp["start_ns"][steps]).sum()
                      / 1e9)
    assert {"writes.host", "overlay.merge", "gets.fetch",
            "scans.pairs"} <= set(idle)


def test_the_untraced_run_never_turns_the_programs_tracer_on(monkeypatch):
    from portbench import index_serving
    from repro_torch.serving.index_engine import BaseIndexEngine
    built = []
    build = index_serving.build_engine

    def keep(*a, **kw):
        built.append(build(*a, **kw))
        return built[-1]

    def refuse(self):
        raise AssertionError("the tracer was turned on")
    monkeypatch.setattr(index_serving, "build_engine", keep)
    monkeypatch.setattr(BaseIndexEngine, "start_trace", refuse)
    out = run_small("covid-200M.w4-read-heavy", steps=2)
    assert out["trace"] is None and built
    eng = built[0]
    assert eng.tracer is None and "submit" not in eng.__dict__
