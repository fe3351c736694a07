"""What a traced run (``--trace 1``) reads, from the benchmark's own files.

* ``PhaseTimers``: the engine's step phases timed on the host clock, each
  device phase ending in a synchronize (a frozen copy of ``chip_smoke.py``
  ``breakdown()``), by wrapping the engine's ``_apply_write`` (host index
  writes), ``_after_writes`` (the overlay merge: batch upload and K2),
  ``_serve_gets`` (upload, K1, results) and ``_serve_scans``; every call's
  span is kept, so the device's idle time can be put to what the host was
  doing.
* ``K1Launches`` / ``K2Merges``: every K1 launch's queries and leaf rows
  (kept on the device until the window has closed) and every K2 merge's
  live counts, for the frozen byte counts of ``bounds.py``.
* ``device_summary``: the ``torch.profiler`` trace of the window (a frozen
  reading of ``chip_smoke.py`` ``index_profile()``): device time by
  operation, the union of device intervals (busy), and the idle time by
  host phase.
"""
from __future__ import annotations

import re
import time

import numpy as np

from . import bounds

# the kernels' names as the profiler gives them, e.g. ``(anonymous
# namespace)::fused_lookup_kernel(...)``, ``void (anonymous namespace)::
# rank_kernel<1>(...)``
_NS = r"^(void )?(\(anonymous namespace\)::)?"
K1_KERNEL = re.compile(_NS + r"fused_lookup_kernel\(")
K2_KERNELS = re.compile(_NS + r"(rank_kernel<\d+>|scatter_kernel)\(")
MARK = "portbench.mark"
PHASES = {"_apply_write": ("host_writes", False),
          "_after_writes": ("overlay_merge", True),
          "_serve_gets": ("gets", True),
          "_serve_scans": ("scans", True)}


class PhaseTimers:
    """Seconds and spans of each engine phase while installed (module
    docstring); host writes are one span a step, from the first write's
    start to the last one's end."""

    def __init__(self, eng, sync):
        self.eng, self.sync = eng, sync
        self.total = {name: 0.0 for name, _ in PHASES.values()}
        self.calls = {name: 0 for name, _ in PHASES.values()}
        self.spans: list[tuple[int, int, str]] = []
        self._writes: list[int] | None = None

    def install(self) -> None:
        for attr, (name, synced) in PHASES.items():
            setattr(self.eng, attr, self._timed(name, getattr(self.eng, attr),
                                                synced))

    def remove(self) -> None:
        for attr in PHASES:
            self.eng.__dict__.pop(attr, None)

    def _timed(self, name, fn, synced):
        pc, sync = time.perf_counter_ns, self.sync

        def run(*a, **kw):
            t = pc()
            out = fn(*a, **kw)
            if synced:
                sync()
            e = pc()
            self.total[name] += (e - t) / 1e9
            self.calls[name] += 1
            if name == "host_writes":
                if self._writes is None:
                    self._writes = [t, e]
                else:
                    self._writes[1] = e
            else:
                self.spans.append((t, e, name))
            return out
        return run

    def end_step(self) -> None:
        if self._writes is not None:
            self.spans.append((*self._writes, "host_writes"))
            self._writes = None


class K1Launches:
    """Every K1 launch the engine makes while ``active``: the queries and
    the leaf rows it returned, kept on the device, and whether it merged
    the overlay; reduced to bytes once the window has closed."""

    NAMES = ("fused_lookup", "fused_lookup_sharded")

    def __init__(self, lookup_module):
        self.mod, self.active, self.launches = lookup_module, False, []
        self.orig = {n: getattr(lookup_module, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(lookup_module, n, self._wrap(self.orig[n], n))

    def _wrap(self, fn, name):
        def run(arrs, ovr, q, height):
            out = fn(arrs, ovr, q, height)
            if self.active and q.shape[0]:
                self.launches.append((q, out[2], ovr is not None,
                                      name == "fused_lookup_sharded"))
            return out
        return run

    def remove(self) -> None:
        for n, fn in self.orig.items():
            setattr(self.mod, n, fn)

    def bound_s(self, mirror: dict) -> float:
        """The launches' least time at the HBM peak, in seconds."""
        def host(t):
            return t.cpu().numpy().reshape(-1)
        llm, root = host(mirror["last_leaf_min"]), host(mirror["meta"])[::2]
        bnd = host(mirror["bounds"]) if "bounds" in mirror else \
            np.empty(0, np.int64)
        cap = int(mirror["leaf_keys"].shape[-1])
        total = 0
        for q, leaf, overlay, sharded in self.launches:
            qh = host(q)
            rows = int(np.unique(host(leaf)).size)
            total += bounds.k1_bytes(qh.shape[0],
                                     bounds.k1_walks(llm, root, bnd, qh),
                                     rows, cap, overlay, sharded,
                                     bnd.size if sharded else 0)
        return bounds.bound_s(total)


class K2Merges:
    """Every K2 merge of the engines' overlay packs: (entries in the served
    pack, batch entries, merged entries, padding slots of the target past
    them).  The merged count is the engines' own exact ``live`` argument;
    the served pack holds the previous merge's, the target (the spare) the
    one before (no compaction may run in the window: ``reseeds`` counts
    what would break that)."""

    def __init__(self, modules):
        self.mods, self.active, self.merges = modules, False, []
        self.orig = modules[0].merge_overlay_pack
        self.hist = [0, 0]            # live of the two packs, older first
        for m in modules:
            m.merge_overlay_pack = self._run

    def _run(self, ovr, batch, cap_out, live=None):
        out = self.orig(ovr, batch, cap_out, live)
        merged = int(live) if live is not None else -1
        if self.active:
            self.merges.append((self.hist[1], int(batch[0].shape[0]),
                                merged, max(0, self.hist[0] - merged)))
        self.hist = [self.hist[1], merged]
        return out

    def remove(self) -> None:
        for m in self.mods:
            m.merge_overlay_pack = self.orig

    def bound_s(self) -> float | None:
        if any(m[2] < 0 for m in self.merges):
            return None
        return bounds.bound_s(sum(bounds.k2_live_bytes(*m)
                                  for m in self.merges))


def _union(starts: np.ndarray, ends: np.ndarray):
    """Disjoint sorted intervals covering the given ones."""
    if not starts.size:
        return starts, ends
    o = np.argsort(starts, kind="stable")
    s, e = starts[o], np.maximum.accumulate(ends[o])
    new = np.r_[True, s[1:] > e[:-1]]
    last = np.r_[new[1:], True]
    return s[new], e[last]


def _busy_until(bs: np.ndarray, be: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Busy time of the disjoint intervals (bs, be) before each time t."""
    cum = np.r_[0, np.cumsum(be - bs)]
    i = np.searchsorted(bs, t, side="right")
    prev_end = np.where(i > 0, be[np.maximum(i - 1, 0)], 0)
    inside = np.where(i > 0, np.minimum(t, prev_end) - bs[np.maximum(i - 1,
                                                                     0)], 0)
    return cum[np.maximum(i - 1, 0)] * (i > 0) + np.maximum(inside, 0)


def device_summary(prof, t0_ns: int, t1_ns: int, mark_ns: int,
                   spans: list, steps: list) -> dict:
    """Read the profiler's events of the window [t0_ns, t1_ns] (host
    ``perf_counter_ns``): device seconds by operation, K1's and K2's
    device seconds and launches, busy seconds (the union of every device
    operation's interval), and idle seconds by host phase: ``spans`` are
    (start, end, label) host spans, ``steps`` (start, end) of the engine's
    steps, whose time outside the spans is ``engine_other``; the rest is
    ``harness``.  ``mark_ns`` is the host time at which the ``MARK`` range
    opened, which ties the two clocks."""
    from torch.autograd import DeviceType
    names, starts, ends = [], [], []
    offset = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or name.startswith("portbench."):
                continue
            names.append(name)
            starts.append(e.start_ns())
            ends.append(e.start_ns() + e.duration_ns())
        elif name == MARK and offset is None:
            offset = e.start_ns() - mark_ns
    if offset is None:
        raise RuntimeError("the profiler recorded no window mark")
    s = np.asarray(starts, np.int64) - offset
    e = np.asarray(ends, np.int64) - offset
    keep = (e > t0_ns) & (s < t1_ns)
    s, e = np.clip(s[keep], t0_ns, t1_ns), np.clip(e[keep], t0_ns, t1_ns)
    names = [n for n, k in zip(names, keep.tolist()) if k]
    by_name: dict[str, float] = {}
    k1 = [0.0, 0]
    k2 = [0.0, 0]
    for n, d in zip(names, ((e - s) / 1e9).tolist()):
        by_name[n] = by_name.get(n, 0.0) + d
        if K1_KERNEL.match(n):
            k1[0] += d
            k1[1] += 1
        elif K2_KERNELS.match(n):
            k2[0] += d
            k2[1] += 1
    bs, be = _union(s, e)
    busy = float((be - bs).sum()) / 1e9
    window = (t1_ns - t0_ns) / 1e9

    def idle_in(sp: np.ndarray) -> np.ndarray:
        if not sp.size:
            return np.zeros(0)
        a, b = sp[:, 0], sp[:, 1]
        return ((b - a) - (_busy_until(bs, be, b) - _busy_until(bs, be, a))
                ) / 1e9
    idle: dict[str, float] = {}
    labelled = 0.0
    for label in sorted({sp[2] for sp in spans}):
        sp = np.array([(a, b) for a, b, lab in spans if lab == label],
                      np.int64).reshape(-1, 2)
        idle[label] = float(idle_in(sp).sum())
        labelled += idle[label]
    st = np.array(steps, np.int64).reshape(-1, 2)
    in_phases = sum(idle.get(k, 0.0) for k in
                    ("host_writes", "overlay_merge", "gets", "scans"))
    idle["engine_other"] = float(idle_in(st).sum()) - in_phases
    idle["harness"] = (window - busy) - labelled - idle["engine_other"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": window,
            "k1_device_s": k1[0], "k1_events": k1[1],
            "k2_device_s": k2[0], "k2_events": k2[1],
            "device_ops": [[n[:120], v] for n, v in top],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:10]}
