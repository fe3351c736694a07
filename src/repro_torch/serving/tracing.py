"""Spans and counters of the index engines' steps, kept in memory.

``eng.start_trace()`` puts a :class:`Tracer` on an engine
(``BaseIndexEngine``), ``eng.stop_trace()`` takes it off and returns it;
``tracer.export()`` gives what it kept as plain lists and NumPy arrays.
Off (``eng.tracer is None``, the default) each span site costs one
``is None`` test and ``submit`` is the class's own function.

A span has a name from :data:`SPANS`, a start and an end
(``time.perf_counter_ns``), its parent (the span open when it opened, -1
for none) and the step it belongs to (``eng.steps`` when its ``step`` span
opened).  The sites, parent first:

* ``step``: ``BaseIndexEngine.step``; counters ``rid_first``,
  ``rid_last`` (the step's request ids), ``writes``, ``gets``, ``scans``;
* ``step.begin``: ``_begin_step`` (a finished background build
  installed);
* ``step.partition``: the queue drained into writes, gets and scans;
* ``writes.host``: the ``_apply_write`` loop; ``writes``, and the host
  indexes' deltas over it: ``block_reads``, ``block_writes``
  (``BlockDevice.stats``), ``leaf_walks``, ``null_scans``,
  ``null_scan_slots`` (``Aulid``'s walk counters);
* ``writes.after``: ``_after_writes``; inside it ``IndexEngine``'s
  ``compact``, ``overlay.merge`` or ``overlay.reseed``
  (``IndexShard.compact`` / ``refresh_overlay_arrays``; a reseed may also
  sit under ``step.begin`` or ``compact``);
* ``gets``: ``_serve_gets``; children ``gets.queries`` (pad and upload),
  ``gets.launch`` (the lookup call, K1 on the card), ``gets.fetch`` (the
  results to the host: where the host waits for the card), ``gets.fill``
  (the results into the requests);
* ``scans``, one a scan-length bucket: ``_serve_scans``; children
  ``scans.queries``, ``scans.launch`` (the scan call), ``scans.fetch``,
  ``scans.pairs`` (rows into Python pairs).

The engine's own totals (``stats()``: swaps, H2D bytes, merges, reseeds)
are not repeated here: difference two ``stats()`` for them.

Collections: while on, each run of the interpreter's garbage collector
(``gc.callbacks``) keeps its start, end and generation.  A collection
runs where an allocation pushed the young generation over its threshold,
inside whatever span or request was running then.  On the benchmark's
w1 cell the 149 full collections of a window (117-142 ms each) made half
of the admission time, so read a submit's own time from the stamped
submits' median, or their mean less the collections inside them.

Admission: while on, the engine's ``submit`` is a stamped one.  One
request in :data:`STAMP_EVERY` on average, at the gaps of
:data:`STAMP_GAPS`, keeps its request id and two stamps,
``perf_counter_ns`` before and after the class's ``submit``;
``admission_ns`` sums the time between them, ``admitted`` counts them.  A
stamped request's latency is its step's ``step`` end less its first
stamp, its queue wait the ``step`` start less it (:func:`request_times`).
Stamping every request cost 1-4.5 us a request on an H100's host, the
more the longer the run (the stamps kept as Python ints); one in 32 keeps
that small while a window of a hundred steps of 8,192 requests still holds
25,600 stamped ones.  The gaps are random: a fixed stride that divides a
step's request count stamps the same places of every step, and the
interpreter's garbage collections, which also fall at the same places of
every step, then land in the stamped submits far more or far less often
than in the others (a stride of 32 read w1's submits at a third of the
harness's admission a request in one run and at twice it in another).

One clock with ``torch.profiler``: ``start_trace`` opens
:data:`ANCHOR_TAKES` ``record_function`` ranges named :data:`ANCHOR` and
stamps ``perf_counter_ns`` inside each (``anchor_ns``, a list); where a
profiler is active, :func:`anchor_offset` takes the shortest range's
midpoint in its trace less its stamp, which maps every span onto the
profiler's clock within half that range.  Ranges took 9-52 us on an H100's
host, the first of a profile the longest.  Start the profiler before the
tracer.
"""
from __future__ import annotations

import time

import numpy as np

ANCHOR = "repro_torch.trace.anchor"
ANCHOR_TAKES = 5
STAMP_EVERY = 32
# uniform in [1, 2 * STAMP_EVERY - 1], drawn once, cycled
STAMP_GAPS = tuple(np.random.default_rng(STAMP_EVERY).integers(
    1, 2 * STAMP_EVERY, 4096).tolist())
SPANS = ("step", "step.begin", "step.partition", "writes.host",
         "writes.after", "compact", "overlay.merge", "overlay.reseed",
         "gets", "gets.queries", "gets.launch", "gets.fetch", "gets.fill",
         "scans", "scans.queries", "scans.launch", "scans.fetch",
         "scans.pairs")
_CODE = {n: i for i, n in enumerate(SPANS)}


class Tracer:
    """Spans and counters of one traced stretch of an engine's life (module
    docstring).  ``open`` / ``close`` / ``lap`` nest on one stack: the
    engine is driven from one thread."""

    def __init__(self):
        self._name: list[int] = []
        self._start: list[int] = []
        self._end: list[int] = []
        self._parent: list[int] = []
        self._step: list[int] = []
        self._open: list[int] = []
        self._counters: list[tuple[int, str, int]] = []
        self._base: list[dict | None] = []
        self.step = -1
        # admission: (request id, stamp before, stamp after) of the stamped
        # submits, flat
        self._stamps: list[int] = []
        # the collections: (start, end, generation), flat
        self._gc: list[int] = []
        self._gc_start = 0
        self.anchor_ns: list[int] = []
        self.start_ns = time.perf_counter_ns()
        self.stop_ns: int | None = None

    def anchor(self) -> None:
        """Stamp the host clock inside each of :data:`ANCHOR_TAKES`
        :data:`ANCHOR` profiler ranges."""
        from torch.profiler import record_function
        for _ in range(ANCHOR_TAKES):
            with record_function(ANCHOR):
                self.anchor_ns.append(time.perf_counter_ns())

    def open(self, name: str, base: dict | None = None) -> None:
        """Open a span under the innermost open one; ``base`` holds the
        counters whose deltas its ``close`` records."""
        i = len(self._name)
        self._name.append(_CODE[name])
        self._parent.append(self._open[-1] if self._open else -1)
        self._step.append(self.step)
        self._end.append(-1)
        self._base.append(base)
        self._open.append(i)
        self._start.append(time.perf_counter_ns())

    def close(self, now: dict | None = None, **counters: int) -> None:
        """Close the innermost open span, recording ``counters`` and, for
        each key of its ``base``, ``now[key] - base[key]``."""
        t = time.perf_counter_ns()
        i = self._open.pop()
        self._end[i] = t
        base = self._base[i]
        if base is not None:
            for k, v in base.items():
                self._counters.append((i, k, int(now[k]) - int(v)))
        for k, v in counters.items():
            self._counters.append((i, k, int(v)))

    def lap(self, name: str) -> None:
        """Close the innermost open span and open its next sibling."""
        self.close()
        self.open(name)

    def collecting(self, phase: str, info: dict) -> None:
        """A ``gc.callbacks`` entry: keeps each collection (the engine
        registers it while tracing)."""
        if phase == "start":
            self._gc_start = time.perf_counter_ns()
            return
        keep = self._gc.append
        keep(self._gc_start)
        keep(time.perf_counter_ns())
        keep(info["generation"])

    def stamped(self, submit):
        """``submit`` with a request stamped at each gap of
        :data:`STAMP_GAPS` (the engine binds this on the instance while
        tracing)."""
        pc, keep, gaps = time.perf_counter_ns, self._stamps.append, STAMP_GAPS
        n = len(gaps)
        i, left = 0, gaps[0]

        def run(op, key, payload=0, count=0):
            nonlocal i, left
            left -= 1
            if left:
                return submit(op, key, payload, count)
            i += 1
            left = gaps[i % n]
            t = pc()
            req = submit(op, key, payload, count)
            keep(pc())
            keep(t)
            keep(req.rid)
            return req
        return run

    def export(self) -> dict:
        """What was kept: ``spans`` (arrays of ``name`` codes into
        ``names``, ``start_ns``, ``end_ns`` (-1 while open), ``parent``,
        ``step``), ``counters`` (counter name -> ``span`` indices and
        ``value``s), ``submit`` (the stamped requests' ``rid``,
        ``start_ns``, ``end_ns``), ``gc`` (the collections' ``start_ns``,
        ``end_ns``, ``generation``), ``admission_ns`` (time inside the
        stamped submits), ``admitted`` (their count), ``stamp_every``
        (their mean gap), ``anchor_ns`` (a list), ``start_ns``,
        ``stop_ns``."""
        i64 = np.int64
        counters: dict[str, dict] = {}
        for i, k, v in self._counters:
            c = counters.setdefault(k, {"span": [], "value": []})
            c["span"].append(i)
            c["value"].append(v)
        s1, s0, rid = np.asarray(self._stamps, i64).reshape(-1, 3).T
        g0, g1, gen = np.asarray(self._gc, i64).reshape(-1, 3).T
        return {
            "names": SPANS,
            "spans": {"name": np.asarray(self._name, np.int16),
                      "start_ns": np.asarray(self._start, i64),
                      "end_ns": np.asarray(self._end, i64),
                      "parent": np.asarray(self._parent, i64),
                      "step": np.asarray(self._step, i64)},
            "counters": {k: {"span": np.asarray(c["span"], i64),
                             "value": np.asarray(c["value"], i64)}
                         for k, c in counters.items()},
            "submit": {"rid": rid, "start_ns": s0, "end_ns": s1},
            "gc": {"start_ns": g0, "end_ns": g1, "generation": gen},
            "admission_ns": int((s1 - s0).sum()),
            "admitted": int(rid.size), "stamp_every": STAMP_EVERY,
            "anchor_ns": list(self.anchor_ns), "start_ns": self.start_ns,
            "stop_ns": self.stop_ns}


def anchor_offset(events, anchor_ns: list[int]) -> int:
    """The profiler's clock less the host's, from a profiler's events
    (``prof.profiler.kineto_results.events()``) and ``export()``'s
    ``anchor_ns``: the shortest host-side :data:`ANCHOR` range's midpoint
    less the stamp taken inside it (the ranges and the stamps in one order);
    raises where the profiler recorded none, or other ranges of that name
    (one tracer's anchors a profile)."""
    from torch.autograd import DeviceType
    ranges = sorted((e.start_ns(), e.duration_ns()) for e in events
                    if e.name() == ANCHOR
                    and e.device_type() != DeviceType.CUDA)
    if not ranges or len(ranges) != len(anchor_ns):
        raise RuntimeError(f"the profiler recorded {len(ranges)} program "
                           f"anchors of {len(anchor_ns)}")
    (start, dur), stamp = min(zip(ranges, anchor_ns),
                              key=lambda rs: rs[0][1])
    return start + dur // 2 - stamp


def span_mask(exp: dict, name: str) -> np.ndarray:
    """Which of ``exp``'s spans are named ``name``."""
    return exp["spans"]["name"] == SPANS.index(name)


def span_seconds(exp: dict, name: str) -> np.ndarray:
    """The durations of ``exp``'s closed spans named ``name``, in seconds."""
    sp = exp["spans"]
    m = span_mask(exp, name) & (sp["end_ns"] >= 0)
    return (sp["end_ns"][m] - sp["start_ns"][m]) / 1e9


def counter_total(exp: dict, counter: str, name: str) -> int | None:
    """The sum of ``counter`` over ``exp``'s spans named ``name``; None
    where no such span carries it."""
    c = exp["counters"].get(counter)
    if c is None:
        return None
    on = span_mask(exp, name)[c["span"]]
    return int(c["value"][on].sum()) if on.any() else None


def request_times(exp: dict) -> tuple[np.ndarray, np.ndarray]:
    """Each stamped request's latency (its step's end less its submit
    stamp) and queue wait (its step's start less the stamp), in seconds,
    for the stamped requests whose step closed while tracing."""
    sp, cnt = exp["spans"], exp["counters"]
    if "rid_first" not in cnt:
        return np.zeros(0), np.zeros(0)
    first, last = cnt["rid_first"], cnt["rid_last"]
    o = np.argsort(first["value"], kind="stable")
    lo, hi = first["value"][o], last["value"][o]
    span = first["span"][o]
    sub = exp["submit"]
    j = np.searchsorted(lo, sub["rid"], side="right") - 1
    ok = (j >= 0) & (sub["rid"] <= hi[np.maximum(j, 0)])
    s = span[j[ok]]
    t = sub["start_ns"][ok]
    return (sp["end_ns"][s] - t) / 1e9, (sp["start_ns"][s] - t) / 1e9
