"""One run of an index cell: ``repro_torch``'s ``IndexEngine`` (one shard)
or ``ShardedIndexEngine`` (range shards) under a closed loop of clients.

Set-up (``setup_s``, from process start): the keys drawn on the device
from the seed; every step of the run drawn (``index_traffic``); the
program's bulkload, mirror build and upload; ``warmup_steps`` steps served
(every shape the window uses, the kernels built on a checkout's first
run).  The window then serves a fixed number of steps,
``index_traffic.window_steps(mix, seconds)``: each step submits one
request of every client (``submit``), runs ``step()`` and reads every
answer, as the clients would.  ``ops_per_s`` is the window's requests over
its wall time.  A request's latency runs from its ``submit`` to the end of
the step that answered it.  Once the window has closed and the peak device
memory is read, the program is freed and every answer of the warm-up and
the window is held to the reference (``check.py``).

A traced run (``trace``) adds the phase timers, the K1/K2 recorders and
the profiler (``trace.py``) around the window; its rate is not reported.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np

from . import check, index_traffic, trace as tr


def build_engine(config: dict, keys: np.ndarray, device):
    """The configuration's engine over ``keys`` (payload key + 1), with
    the engine's own defaults."""
    from repro_torch.core import Aulid, BlockDevice, partition_bulkload
    from repro_torch.serving import IndexEngine, ShardedIndexEngine
    pays = keys + np.uint64(1)
    shards = int(config.get("shards", 1))
    if config["engine"] == "IndexEngine" and shards == 1:
        idx = Aulid(BlockDevice())
        idx.bulkload(keys.copy(), pays)
        return IndexEngine(idx, device=device)
    if config["engine"] == "ShardedIndexEngine" and shards > 1:
        return ShardedIndexEngine(partition_bulkload(keys.copy(), pays,
                                                     shards), device=device)
    raise ValueError(f"no engine {config['engine']!r} with {shards} shards")


class Clients:
    """The closed loop: submit a step's requests, step, read the answers.
    Answers are kept as the clients read them, for the check."""

    def __init__(self, eng, traffic: index_traffic.IndexTraffic):
        self.eng, self.traffic = eng, traffic
        t = traffic
        self.nw, self.ng, self.ns = t.nw, t.ng, t.ns
        self.acks, self.gets, self.scans = [], [], []
        self.unanswered = 0
        self.served = []          # steps served, in order

    def submit(self, s: int, stamps: list | None = None) -> list:
        """Submit step ``s``'s requests; with ``stamps``, each submit's
        host time (``perf_counter_ns``) is appended to it."""
        st, sub, t = self.traffic.step(s), self.eng.submit, self.traffic
        args = zip(t.ops, st.keys.tolist(), st.pays.tolist(), t.counts)
        if stamps is None:
            return [sub(o, k, p, c) for o, k, p, c in args]
        pc, reqs = time.perf_counter_ns, []
        for o, k, p, c in args:
            stamps.append(pc())
            reqs.append(sub(o, k, p, c))
        return reqs

    def serve(self, s: int) -> int:
        """Serve step ``s``; returns the requests done."""
        reqs = self.submit(s)
        self.eng.step()
        return self.read(s, reqs)

    def read(self, s: int, reqs: list) -> int:
        miss = check.MISSING
        nw, ng = self.nw, self.ng
        self.acks += [r.result if r.done else miss for r in reqs[:nw]]
        self.gets += [r.result if r.done else miss for r in reqs[nw:nw + ng]]
        scans = reqs[nw + ng:]
        self.scans += [scans[i].result if scans[i].done else miss
                       for i in self.traffic.step(s).scan_check.tolist()]
        not_done = sum(not r.done for r in reqs)
        self.unanswered += not_done
        self.served.append(s)
        return len(reqs) - not_done

    def check_steps(self) -> list:
        """The served steps in the reference's form."""
        return [self.traffic.ref_step(s) for s in self.served]

    def got(self) -> dict:
        return {"acks": self.acks, "gets": self.gets, "scans": self.scans,
                "unanswered": self.unanswered}


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        steps: int | None = None) -> dict:
    """One run of ``cell`` (``spec.Cell``); returns the result line's
    fields.  ``steps`` sets the window's steps in place of the mix's rate
    times ``seconds`` (the CPU tests' short runs)."""
    import torch
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    mix, conf = cell.traffic, cell.config
    warm = int(mix.get("warmup_steps", 3))
    n_win = index_traffic.window_steps(mix, seconds) if steps is None \
        else int(steps)
    # -- set-up: the data, then the program (its peak is read from here)
    t = time.perf_counter()
    keys, traffic = index_traffic.for_cell(conf, mix, seed, warm + n_win,
                                           dev)
    marks = {"imports": t - t0, "keys and traffic": time.perf_counter() - t}
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    eng = build_engine(conf, keys, dev)
    marks["engine"] = time.perf_counter() - t
    if trace:
        from repro_torch.core import lookup
        from repro_torch.serving import index_engine, sharded_engine
        k1 = tr.K1Launches(lookup)
        k2 = tr.K2Merges([index_engine, sharded_engine])
    clients = Clients(eng, traffic)
    t = time.perf_counter()
    for s in range(warm):
        clients.serve(s)
    sync()
    marks["warmup"] = time.perf_counter() - t
    gc.collect()
    gc.freeze()            # set-up's objects: out of every later collection
    # -- the window
    lat, spans, step_spans = [], [], []
    reseeds = eng.stats()["overlay_reseeds"]
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        timers = tr.PhaseTimers(eng, sync)
        timers.install()
        k1.active = k2.active = True
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
        with record_function(tr.MARK):
            mark = time.perf_counter_ns()
    t_start = time.perf_counter()
    setup_s = t_start - t0
    pc = time.perf_counter_ns
    w0 = pc()
    done = attempted = 0
    for s in range(warm, warm + n_win):
        if trace:
            a0, stamps = pc(), []
            reqs = clients.submit(s, stamps)
            a1 = pc()
            eng.step()
            e1 = pc()
            timers.end_step()
            done += clients.read(s, reqs)
            c1 = pc()
            lat.append((e1 - np.asarray(stamps, np.int64)) / 1e9)
            spans += [(a0, a1, "admission"), (e1, c1, "client")]
            step_spans.append((a1, e1))
        else:
            done += clients.serve(s)
        attempted += traffic.nw + traffic.ng + traffic.ns
    sync()
    window_s = time.perf_counter() - t_start
    w1 = pc()
    summary = None
    if trace:
        prof.__exit__(None, None, None)
        timers.remove()
        k1.active = k2.active = False
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    # -- the traced run's readings, then the program freed
    tdata = None
    if trace:
        if cuda:
            summary = tr.device_summary(prof, w0, w1, mark,
                                        spans + timers.spans, step_spans)
        mirror = eng.stk if hasattr(eng, "stk") else eng.arrs
        tdata = {"steps": n_win, "requests": attempted,
                 "latency_s": np.concatenate(lat) if lat else np.zeros(0),
                 "phase_s": dict(timers.total),
                 "phase_calls": dict(timers.calls),
                 "k1_launches": len(k1.launches),
                 "k1_bound_s": k1.bound_s(mirror) if k1.launches else None,
                 "k2_merges": len(k2.merges),
                 # a reseed in the window breaks K2Merges' live counts
                 "k2_bound_s": k2.bound_s() if reseeds ==
                 eng.stats()["overlay_reseeds"] else None,
                 "device": summary}
        k1.remove()
        k2.remove()
        del k1, k2, prof, timers, mirror
    engine_stats = {k: v for k, v in eng.stats().items()
                    if k in ("compactions", "overlay_reseeds", "swaps")}
    del eng, clients.eng
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # -- the check, over every step served (warm-up included)
    t = time.perf_counter()
    counts, live = check.compare(keys, clients.check_steps(), clients.got())
    marks["check"] = time.perf_counter() - t
    log("set-up and check, s: " + " ".join(f"{k} {v:.3f}"
                                           for k, v in marks.items()))
    metrics = {"ops_per_s": {"value": done / window_s, "unit": "ops/s"},
               "device_bytes_per_key": {"value": peak / live,
                                        "unit": "B/key"},
               "setup_s": {"value": setup_s, "unit": "s"}}
    return {"counts": counts, "attempted": attempted,
            "failed": counts["unanswered"], "metrics": metrics,
            "memory_peak_bytes": peak, "trace": tdata,
            "window_s": window_s, "steps": n_win,
            "engine": engine_stats}


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)
