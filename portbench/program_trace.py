"""The program's own spans (``repro_torch.serving.tracing``) on the
profiler's clock: the card's idle time put to the innermost program span
open at each instant.

``device_intervals`` reads a ``torch.profiler`` trace: every device
operation's interval, moved onto the host's ``perf_counter_ns`` clock by
the program's anchor (``tracing.anchor_offset``: the midpoint of the
shortest ``repro_torch.trace.anchor`` range that ``start_trace`` opens,
less the ``anchor_ns`` stamp taken inside it).
``idle_by_span`` then splits a window's idle time (its wall time less the
union of the device intervals) by the innermost program span, each
span's self time, and the interpreter's collections (``gc``); what lies
in none is ``outside_program``.  The
union and the busy-time prefix sums are ``trace.py``'s.
"""
from __future__ import annotations

import numpy as np

from .trace import _busy_until, _union


def device_intervals(prof, anchor_ns: list[int]
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Start and end (host ``perf_counter_ns``) of every device operation
    in ``prof``'s trace; raises where the trace holds no program anchor."""
    from torch.autograd import DeviceType

    from repro_torch.serving.tracing import anchor_offset
    events = list(prof.profiler.kineto_results.events())
    offset = anchor_offset(events, anchor_ns)
    starts, ends = [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA and not (
                e.is_user_annotation()
                or e.name().startswith(("portbench.", "repro_torch."))):
            starts.append(e.start_ns())
            ends.append(e.start_ns() + e.duration_ns())
    return (np.asarray(starts, np.int64) - offset,
            np.asarray(ends, np.int64) - offset)


def self_segments(program: dict) -> tuple[np.ndarray, np.ndarray, list]:
    """The closed spans of a ``Tracer.export()`` and its collections (named
    ``gc``, inside whatever span was open) cut into the pieces where each
    is the innermost: (starts, ends, names)."""
    sp = program["spans"]
    closed = np.flatnonzero(sp["end_ns"] >= 0)
    names = [program["names"][c] for c in sp["name"][closed]]
    starts = sp["start_ns"][closed].tolist()
    ends = sp["end_ns"][closed].tolist()
    if "gc" in program:
        g = program["gc"]
        starts += g["start_ns"].tolist()
        ends += g["end_ns"].tolist()
        names += ["gc"] * g["start_ns"].size
    # opens before closes at one instant; the later-opened (a child, or a
    # collection) opens after and closes before the earlier one
    ev = sorted([(t, 0, i) for i, t in enumerate(starts)]
                + [(t, 1, -i) for i, t in enumerate(ends)])
    seg_s, seg_e, seg_n = [], [], []
    stack: list[int] = []
    last = None
    for t, kind, i in ev:
        if stack and t > last:
            seg_s.append(last)
            seg_e.append(t)
            seg_n.append(names[stack[-1]])
        if kind == 0:
            stack.append(i)
        else:
            stack.remove(-i)
        last = t
    return (np.asarray(seg_s, np.int64), np.asarray(seg_e, np.int64),
            seg_n)


def idle_by_span(program: dict, dev_s: np.ndarray, dev_e: np.ndarray,
                 t0_ns: int, t1_ns: int) -> dict:
    """Idle seconds of the window [t0_ns, t1_ns] (host clock) by innermost
    program span, and ``outside_program``; largest first."""
    keep = (dev_e > t0_ns) & (dev_s < t1_ns)
    bs, be = _union(np.clip(dev_s[keep], t0_ns, t1_ns),
                    np.clip(dev_e[keep], t0_ns, t1_ns))
    s, e, names = self_segments(program)
    s, e = np.clip(s, t0_ns, t1_ns), np.clip(e, t0_ns, t1_ns)
    idle = (e - s) / 1e9
    if bs.size:
        idle -= (_busy_until(bs, be, e) - _busy_until(bs, be, s)) / 1e9
    out: dict[str, float] = {}
    for n, v in zip(names, idle.tolist()):
        out[n] = out.get(n, 0.0) + v
    window_idle = ((t1_ns - t0_ns) - float((be - bs).sum())) / 1e9
    out["outside_program"] = window_idle - sum(out.values())
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
