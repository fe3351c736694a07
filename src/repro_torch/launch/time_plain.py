"""Time K1 (with ``--staged`` K3, K4 and K5, with ``--merge`` K2) from
several source trees of the port, interleaved in one process on one card,
so that two versions are compared on one host: each tree's kernel over a
sweep of batch sizes,
and K1's plain version (``lookup_plain``, the read of every
``device="cpu"`` engine):

    python -m repro_torch.launch.time_plain --keys 200000000 \\
        --tree before=smoke_tree/old/src --tree after=src \\
        --queries 256,1024,8192,65536 --shards 8 --lm --staged

Each ``--tree NAME=SRC`` loads ``SRC/repro_torch`` as a package of its own,
which builds its kernels into its own ``_build/``; the mirrors are built by
the running package and shared.  Every tree's outputs must equal the
first tree's, and its kernel's its plain version's.  It prints one JSON
row a measurement, in two rounds (the second in reverse tree order):

- ``kernel``: each tree's ``fused_lookup`` over the ``--keys`` covid mirror
  (and with ``--shards S`` its ``fused_lookup_sharded`` over the same keys
  in S range shards), without and with an overlay pack of the served
  shape (2^24 slots, 28,160 live), at each ``--queries`` batch size: the
  median device time of a launch, L2 flushed and the stream held, beside
  its bytes bound (``fused_lookup.ops.k1_bytes``, a slot record only for
  the queries that enter the inner tree).  A time flat in Q is the
  dependent chain; one that grows with Q, the bytes;
- ``lm`` (with ``--lm``): the kernel on an LM page table's mirror (8
  sequences of 3-17 pages in a ``LearnedPageTable``), Q = 256 = 8 slots x
  32 pages, no overlay: the LM serving step's translation;
- ``plain``: the plain version at Q = 8192, its median wall time (host and
  device, synchronized), on the card also its device time with the stream
  held until the call is enqueued, and the aten operations one call runs;
- ``staged`` (with ``--staged``): at each ``--queries`` batch size, each
  tree's K5 ``probe_level`` on the slots of the staged read's own first
  two K5 launches over the same mirror and queries (round 1's root
  predictions, round 2's slots), and its K3 ``overlay_probe`` on the
  served pack, beside ``torch.searchsorted``'s rank: device times as for
  ``kernel``, each held to the first tree's plain version, with its bytes
  bound and its dependent round trips a query as counted from the sources
  (K5: its slot and key, ``next_occ``, a record a visited slot, mean and
  most, with the walk's hops and records; K3, in a ``k3_plan`` row for the
  running package's kernel: the lanes a query this batch gets, and its
  key, the search's rounds and the record);
  and its K4 ``leaf_search`` on the staged read's own final leaf rows and,
  for the narrow and wide width classes, on pools of 64- and 1020-key rows
  drawn from the mirror's keys (rows drawn at random, a key of the row or,
  one in ten, any key): each
  tree's kernel at its own plan and, where its ops have a ``k4_lanes``
  plan, its launcher called at 1, 2, 4, 8 and 16 lanes a query, beside
  ``torch.searchsorted`` over the rows gathered beforehand (rank only, the
  gather not timed), with the search bound (``leaf_search.ops.k4_bytes``
  over ``k4_least_sectors``: the fewest sectors any lanes read) and the
  whole-row bound (``k4_row_bytes``), and a ``k4_plan`` row: the lanes
  the running package's plan gives, the trips a query and the sectors
  read at each lanes (``k4_walk``);
  and a ``floor`` row a round, a one-element fill timed the same way: the
  launch and the events alone, no dependent load;
- ``merge`` (with ``--merge``): each tree's K2 ``overlay_merge`` on a
  2^24-slot pack holding ``MERGE_FILLS`` live entries, at each of
  ``MERGE_BATCHES`` batch sizes (a quarter of the batch overwrites), in
  the tree's own steady-state form: a tree whose ops have
  ``merge_overlay_into_torch`` merges into a target holding the pack
  (padding past the fill, as the engines' spare holds), an older one
  writes a fresh pack; and the running tree's merge into a fresh target.
  Device times as for ``kernel``, every output held to the first tree's
  plain version, beside the live-entry bound (the live entries in, the
  merged ones out, 24 bytes each) and the full rewrite's; a
  ``merge_split`` row of the running tree's steady merge by kernel (rank
  and scatter, ``torch.profiler``); a ``floor`` row a round.

On the CPU (``--device cpu``) only the ``plain`` rows are printed.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import pathlib
import sys
import time
import types

import numpy as np
import torch

from ..kernels.fused_lookup.ops import HBM_BYTES_PER_S, k1_bytes, k1_walks

HOLD_CYCLES = 100_000_000   # about 50 ms of spinning: a plain call's enqueue
KERNEL_HOLD_CYCLES = 2_000_000  # about 1 ms: one launch's enqueue
QUERIES = 8192              # the serving step's get batch
ROUNDS = 2                  # the second in reverse tree order
OV_CAP, OV_LIVE = 1 << 24, 28_160   # the served overlay pack (PERF.md §6)
LM_SLOTS, LM_PAGES = 8, 32  # the LM engine's slots and pages a sequence
K4_POOL_ROWS = 1 << 15      # rows of each K4 width-class pool
K4_FORCED = (1, 2, 4, 8, 16)        # K4's lanes a query, each timed
MERGE_CAP = 1 << 24                 # the served overlay pack's slots
MERGE_FILLS = (OV_LIVE, 1 << 16, 1 << 20, 1 << 22, 1 << 23)
MERGE_BATCHES = (64, 512, 4096)


def _load_tree(name: str, src: str) -> types.SimpleNamespace:
    """``SRC/repro_torch`` as the package ``name``: its kernels' ops
    modules, K1 (``k1``), K2 (``k2``), K3 (``k3``), K4 (``k4``) and K5
    (``k5``)."""
    init = pathlib.Path(src).resolve() / "repro_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    ops = name + ".kernels.{}.ops"
    return types.SimpleNamespace(**{
        k: importlib.import_module(ops.format(m)) for k, m in
        (("k1", "fused_lookup"), ("k2", "overlay_merge"),
         ("k3", "overlay_probe"),
         ("k4", "leaf_search"), ("k5", "inner_probe"))})


def _wall_ms(fn, reps: int, cuda: bool) -> float:
    ts = []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        ts.append(time.perf_counter() - t)
    return float(np.median(ts)) * 1e3


def _device_ms(fn, reps: int, hold: int = HOLD_CYCLES, flush=None) -> float:
    """Median device time of ``fn`` over ``reps`` calls, each after a write
    of ``flush`` (evicting L2) and a stream hold of ``hold`` cycles, so the
    events time the device's work, not the host's enqueue."""
    fn()
    evs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(hold)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in evs]))


def _aten_ops(fn) -> int:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith("aten::"))


def _agree(outs: dict, exp, what: str) -> None:
    """Every tree's outputs equal ``exp`` (the first tree's plain ones)."""
    for name, got in outs.items():
        if not all(torch.equal(a, b) for a, b in zip(got, exp)):
            raise AssertionError(f"{what}: tree {name} != the plain version")


def _queries(rng, keys: np.ndarray, Q: int) -> np.ndarray:
    n_abs = Q // 10
    return np.concatenate([rng.choice(keys, Q - n_abs),
                           rng.integers(int(keys[0]), int(keys[-1]), n_abs,
                                        dtype=np.uint64)])


def _served_pack(rng, keys: np.ndarray) -> np.ndarray:
    """The served overlay pack's shape: OV_CAP slots, OV_LIVE live entries
    (half the mirror's keys, 10% tombstones), padding last."""
    pack = np.full((3, OV_CAP), np.iinfo(np.uint64).max, dtype=np.uint64)
    pack[1:] = 0
    fresh = rng.integers(int(keys[0]), int(keys[-1]), OV_LIVE,
                         dtype=np.uint64)
    live = np.unique(np.concatenate([rng.choice(keys, OV_LIVE // 2),
                                     fresh]))[:OV_LIVE]
    n = live.shape[0]
    pack[0, :n], pack[1, :n] = live, live * np.uint64(3)
    pack[2, :n] = rng.random(n) < 0.1
    return pack


def _lm_case(dev):
    """An LM page table's mirror and one translation batch: 8 live
    sequences of 3-17 pages (prompts of 32-256 tokens plus 16 new, pages of
    16) allocated as the engine does, queried for 8 slots x 32 pages."""
    from ..serving.kv_cache import LearnedPageTable, PagePool
    rng = np.random.default_rng(0)
    table = LearnedPageTable(PagePool(512), device=dev)
    seqs = np.arange(9, 9 + LM_SLOTS)          # after a first batch
    for s in seqs:
        for lp in range(int(rng.integers(3, 18))):
            table.alloc_page(int(s), lp)
    keys = (np.repeat(seqs, LM_PAGES).astype(np.uint64) << np.uint64(20)) \
        | np.tile(np.arange(LM_PAGES), LM_SLOTS).astype(np.uint64)
    table.translate_batch(np.repeat(seqs, LM_PAGES),
                          np.tile(np.arange(LM_PAGES), LM_SLOTS))
    return table._arrs, keys, max(table._mirror.max_inner_height, 3)


def _sweep(trees: dict, form: str, mirror: dict, cases: dict, qs: dict,
           h: int, flush, r: int, reps: int, cap: int,
           n_bounds: int = 0) -> None:
    """One round of kernel rows: every tree's ``form`` on ``mirror`` for
    each overlay case and batch, held to the first tree's plain version."""
    sharded = form == "fused_lookup_sharded"
    plain = "lookup_sharded_plain" if sharded else "lookup_plain"
    first = next(iter(trees.values())).k1
    order = list(trees) if r % 2 == 0 else list(trees)[::-1]
    for case, ovr in cases.items():
        for Q, qt in qs.items():
            exp = getattr(first, plain)(mirror, ovr, qt, h)
            outs = {n: getattr(trees[n].k1, form)(mirror, ovr, qt, h)
                    for n in order}
            _agree(outs, exp, f"{form} Q={Q} {case}")
            rows = int(torch.unique(exp[2]).numel())
            walks = k1_walks(mirror, qt)
            nbytes = k1_bytes(Q, walks, rows, cap, ovr is not None, sharded,
                              n_bounds)
            for name in order:
                fn = getattr(trees[name].k1, form)
                ms = _device_ms(lambda: fn(mirror, ovr, qt, h), reps,
                                KERNEL_HOLD_CYCLES, flush)
                print(json.dumps({
                    "row": "kernel", "round": r, "tree": name, "form": form,
                    "case": case, "Q": Q, "device_ms": ms,
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "leaf_rows": rows, "walks": walks}), flush=True)


def _staged_inputs(pi, qs: dict) -> dict:
    """K5's inputs at each batch size: the slots of the staged read's own
    first two K5 launches (round 1's root predictions, round 2's slots),
    taken from the running package's ``inner_probe_lookup(..., trace=[])``
    on the same queries, so the hop mix is the served one; with each
    round's walk (``probe_walk``: records, hops, stop)."""
    from ..kernels.inner_probe.ops import inner_probe_lookup, probe_walk
    out = {}
    for Q, qt in qs.items():
        trace = []
        inner_probe_lookup(pi, qt, trace=trace)
        slots = [args[1] for fn, args, _ in trace if fn == "probe_level"]
        out[Q] = {r + 1: (s, probe_walk(pi.arrs, s, qt))
                  for r, s in enumerate(slots[:2])}
    return out


def _k4_inputs(pi, qs: dict, keys: np.ndarray) -> dict:
    """K4's inputs at each batch size, (keys, pay, rows, queries) by name:
    the staged read's own final leaf search (its rows and queries, from the
    running package's trace), and pools of the PA and BT rows' widest
    classes (``AulidConfig``'s largest PA class, 64, and B+-tree
    threshold, 1020 items; the covid mirror has few or none of its own):
    ``K4_POOL_ROWS`` rows each of 40-100% of the width drawn from ``keys``,
    sorted, padding last; each query a random row and a key of it or, one
    in ten, any key of the range."""
    from ..core.aulid import AulidConfig
    from ..core.keys import keys_to_tensor
    from ..kernels.inner_probe.ops import inner_probe_lookup
    rng = np.random.default_rng(11)
    cfg = AulidConfig()
    dev = pi.arrs["leaf_keys"].device
    pools = {}
    for name, C in (("pa-width rows", cfg.pa_classes[-1]),
                    ("bt-width rows", cfg.bt_threshold)):
        kn = np.sort(rng.choice(keys, (K4_POOL_ROWS, C)), axis=1)
        live = rng.integers(C * 2 // 5, C + 1, K4_POOL_ROWS)
        kn[np.arange(C)[None, :] >= live[:, None]] = np.uint64(2**64 - 1)
        kt = keys_to_tensor(kn.reshape(-1), dev).reshape(kn.shape)
        pools[name] = (kt, torch.arange(kt.numel(), device=dev).reshape(
            kt.shape), live)
    lo, hi = keys_to_tensor(keys[[0, -1]], "cpu").tolist()
    out = {}
    for Q, qt in qs.items():
        trace = []
        inner_probe_lookup(pi, qt, trace=trace)
        out[Q] = {"leaf rows": [args for fn, args, _ in trace
                                if fn == "leaf_search"][-1]}
        for name, (kt, pay, live) in pools.items():
            r = rng.integers(0, K4_POOL_ROWS, Q)
            col = (rng.random(Q) * live[r]).astype(np.int64)
            rt = torch.from_numpy(r.astype(np.int32)).to(dev)
            q = kt[rt.long(), torch.from_numpy(col).to(dev)].cpu().numpy()
            q[9::10] = rng.integers(lo, hi, q[9::10].shape[0],
                                    endpoint=True, dtype=np.int64)
            out[Q][name] = (kt, pay, rt, torch.from_numpy(q).to(dev))
    return out


def _k4_forced(k4, keys, pay, rows, q, lanes: int):
    """A tree's K4 launcher called at ``lanes`` a query, where its
    ``leaf_search`` takes the plan's: (payload, found)."""
    lib = k4._build.load("leaf_search", k4._bind)
    Q = q.shape[0]
    out = torch.empty(Q, dtype=torch.int64, device=q.device)
    found = torch.empty(Q, dtype=torch.bool, device=q.device)
    err = lib.leaf_search_launch(
        keys.data_ptr(), pay.data_ptr(), keys.shape[0], keys.shape[1],
        rows.data_ptr(), q.data_ptr(), Q, out.data_ptr(), found.data_ptr(),
        lanes, torch.cuda.current_stream(q.device).cuda_stream)
    k4._build.check(err, "leaf_search")
    return out, found


def _k4_sweep(trees: dict, k4_in: dict, flush, r: int, reps: int) -> None:
    """One round of K4 rows at one batch size: every tree's
    ``leaf_search`` on each input, at its plan and, where it has a lanes
    plan, at each forced lane count, and ``torch.searchsorted`` on the
    rows gathered beforehand, held to the first tree's plain version."""
    from ..kernels.leaf_search.ops import (k4_bytes, k4_lanes,
                                           k4_least_sectors, k4_row_bytes,
                                           k4_trips, k4_walk)
    first = next(iter(trees.values()))
    order = list(trees) if r % 2 == 0 else list(trees)[::-1]
    for name_in, (keys, pay, rows, q) in k4_in.items():
        Q, C = q.shape[0], keys.shape[1]
        exp = first.k4.leaf_search_plain(keys, pay, rows, q)
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        plan = k4_lanes(C, Q, sms)
        n_rows = int(torch.unique(rows.long().clamp(
            0, keys.shape[0] - 1)).numel())
        in_row = int((k4_walk(keys, rows, q, 1)[0] < C).sum())
        least, least_lanes = k4_least_sectors(keys, rows, q)
        bound = k4_bytes(Q, least, in_row) / HBM_BYTES_PER_S * 1e3
        row_bound = k4_row_bytes(Q, n_rows, C) / HBM_BYTES_PER_S * 1e3
        print(json.dumps({"row": "k4_plan", "round": r, "input": name_in,
                          "Q": Q, "C": C, "lanes": plan,
                          "trips": k4_trips(C, plan), "sectors": {
                              g: int(k4_walk(keys, rows, q, g)[2].numel())
                              for g in (plan, *K4_FORCED)},
                          "least_sectors": least, "least_lanes": least_lanes,
                          "rows": n_rows, "bound_ms": bound,
                          "row_bound_ms": row_bound}), flush=True)
        # (tree, call, lanes it runs at: None where its plan is unknown)
        runs = []
        for name in order:
            k4 = trees[name].k4
            planned = hasattr(k4, "k4_lanes")
            runs.append((name, lambda k4=k4: k4.leaf_search(keys, pay, rows,
                                                            q),
                         plan if planned else None))
            if planned:
                runs += [(name, lambda k4=k4, g=g: _k4_forced(
                    k4, keys, pay, rows, q, g), g) for g in K4_FORCED]
        for name, call, g in runs:
            _agree({name: call()}, exp,
                   f"leaf_search {name_in} Q={Q} lanes={g}")
        blk = keys[rows.long().clamp(0, keys.shape[0] - 1)]
        qc = q[:, None].contiguous()
        runs.append(("torch.searchsorted",
                     lambda: torch.searchsorted(blk, qc), None))
        for name, call, lanes in runs:
            ms = _device_ms(call, reps, KERNEL_HOLD_CYCLES, flush)
            print(json.dumps({
                "row": "staged", "round": r, "tree": name,
                "kernel": "leaf_search", "input": name_in, "Q": Q, "C": C,
                "lanes": lanes, "device_ms": ms, "bound_ms": bound,
                "row_bound_ms": row_bound,
                "trips": k4_trips(C, lanes) if lanes else None}),
                  flush=True)
        del blk


def _staged_sweep(trees: dict, arrs: dict, ovr: dict, qs: dict,
                  k5_in: dict, k4_in: dict, flush, r: int,
                  reps: int) -> None:
    """One round of staged rows: every tree's K5 on each round's slots, K3
    on the served pack and K4 on its inputs (:func:`_k4_sweep`) at each
    batch size, held to the first tree's plain versions, beside their
    bounds, dependent trips a query and ``torch.searchsorted`` (K3's and
    K4's rank)."""
    from ..kernels.inner_probe.ops import k5_bytes
    from ..kernels.overlay_probe.ops import (k3_bytes, k3_lanes,
                                             lower_bound_rounds)
    first = next(iter(trees.values()))
    order = list(trees) if r % 2 == 0 else list(trees)[::-1]
    pack = ovr["ov_pack"]
    one = torch.zeros(1, dtype=torch.int64, device=pack.device)
    print(json.dumps({"row": "floor", "round": r, "device_ms": _device_ms(
        one.zero_, reps, KERNEL_HOLD_CYCLES, flush)}), flush=True)
    for Q, qt in qs.items():
        for rnd, (s, walk) in k5_in[Q].items():
            exp = first.k5.probe_level_plain(arrs, s, qt)
            trips = 2 + walk[0]
            for name in order:
                fn = trees[name].k5.probe_level
                _agree({name: fn(arrs, s, qt)}, exp,
                       f"inner_probe Q={Q} round {rnd}")
                ms = _device_ms(lambda: fn(arrs, s, qt), reps,
                                KERNEL_HOLD_CYCLES, flush)
                print(json.dumps({
                    "row": "staged", "round": r, "tree": name,
                    "kernel": "inner_probe", "input": f"round {rnd}",
                    "Q": Q, "device_ms": ms,
                    "bound_ms": k5_bytes(*walk) / HBM_BYTES_PER_S * 1e3,
                    "trips_mean": float(trips.double().mean()),
                    "trips_max": int(trips.max()),
                    "hops": torch.bincount(walk[1], minlength=4).tolist(),
                    "records": torch.bincount(walk[0],
                                              minlength=5).tolist()}),
                      flush=True)
        exp = first.k3.overlay_probe_plain(ovr, qt)
        _agree({n: trees[n].k3.overlay_probe(ovr, qt) for n in order}, exp,
               f"overlay_probe Q={Q}")
        bound = k3_bytes(Q, int(exp[1].sum())) / HBM_BYTES_PER_S * 1e3
        lanes = k3_lanes(Q, torch.cuda.get_device_properties(
            pack.device).multi_processor_count)
        print(json.dumps({"row": "k3_plan", "round": r, "Q": Q,
                          "lanes": lanes, "trips": lower_bound_rounds(
                              pack.shape[1], lanes) + 2}), flush=True)
        runs = [(n, trees[n].k3.overlay_probe) for n in order] \
            + [("torch.searchsorted", None)]
        for name, fn in runs:
            call = (lambda: torch.searchsorted(pack[0], qt)) if fn is None \
                else (lambda: fn(ovr, qt))
            ms = _device_ms(call, reps, KERNEL_HOLD_CYCLES, flush)
            print(json.dumps({
                "row": "staged", "round": r, "tree": name,
                "kernel": "overlay_probe", "input": "served pack", "Q": Q,
                "device_ms": ms, "bound_ms": bound}),
                  flush=True)
        _k4_sweep(trees, k4_in[Q], flush, r, reps)


def _merge_case(fill: int, cb: int, dev, gen) -> tuple:
    """A (3, MERGE_CAP) pack of ``fill`` random live entries (10%
    tombstones) and a (3, cb) batch of 7/8 live entries, a quarter of them
    keys of the pack, built on the card."""
    from ..core.keys import BIASED_MAX
    nb = cb - cb // 8
    over = nb // 4
    pool = torch.unique(torch.randint(-2**62, 2**62, (fill + nb + 4096,),
                                      device=dev, generator=gen))
    pool = pool[torch.randperm(pool.numel(), device=dev, generator=gen)]
    pk = pool[:fill].sort().values
    bk = torch.cat([pk[torch.randperm(fill, device=dev, generator=gen)[:over]],
                    pool[fill:fill + nb - over]]).sort().values

    def pack(keys, cap):
        n = keys.numel()
        p = torch.zeros((3, cap), dtype=torch.int64, device=dev)
        p[0] = BIASED_MAX
        p[0, :n] = keys
        p[1, :n] = torch.randint(0, 2**62, (n,), device=dev, generator=gen)
        p[2, :n] = torch.rand(n, device=dev, generator=gen) < 0.1
        return p
    return pack(pk, MERGE_CAP), pack(bk, cb)


def _kernel_split(fn, reps: int, flush) -> dict:
    """Device ms a call of ``fn`` spends in each of the running tree's K2
    kernels (``torch.profiler``, ``reps`` calls, L2 flushed before each)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for k in ("rank_kernel", "scatter_kernel"):
            if e.device_type == DeviceType.CUDA and k in e.key:
                us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
                out[k + "_ms"] = us / 1e3 / reps
    return out


def _merge_sweep(trees: dict, flush, r: int, reps: int) -> None:
    """One round of ``merge`` rows: every tree's K2 at each fill and batch
    size in its steady-state form (into a target that holds the pack when
    its ops merge into targets, else a fresh pack), and the running
    tree's merge into a fresh target, held to the first tree's plain
    version."""
    from ..core.keys import BIASED_MAX
    from ..kernels.overlay_merge import ops as own
    first = next(iter(trees.values()))
    order = list(trees) if r % 2 == 0 else list(trees)[::-1]
    dev = flush.device
    one = torch.zeros(1, dtype=torch.int64, device=dev)
    print(json.dumps({"row": "floor", "round": r, "device_ms": _device_ms(
        one.zero_, reps, KERNEL_HOLD_CYCLES, flush)}), flush=True)
    gen = torch.Generator(device=dev).manual_seed(17)
    for fill in MERGE_FILLS:
        for cb in MERGE_BATCHES:
            pack, batch = _merge_case(fill, cb, dev, gen)
            exp = first.k2.merge_overlay_pack_torch(pack, batch, MERGE_CAP)
            nb = int((batch[0] != BIASED_MAX).sum())
            merged = int((exp[0] != BIASED_MAX).sum())
            live_ms = 24 * (fill + nb + merged) / HBM_BYTES_PER_S * 1e3
            rewrite_ms = 24 * (fill + nb + MERGE_CAP) / HBM_BYTES_PER_S * 1e3
            tgt = pack.clone()
            runs = []
            for name in order:
                k2 = trees[name].k2
                if hasattr(k2, "merge_overlay_into_torch"):
                    runs.append((name, "steady", lambda k2=k2: k2.overlay_merge(
                        pack, batch, MERGE_CAP, out=tgt, fill=fill,
                        out_fill=fill), tgt))
                else:
                    runs.append((name, "fresh", lambda k2=k2: k2.overlay_merge(
                        pack, batch, MERGE_CAP), None))
            runs.append(("own", "fresh", lambda: own.overlay_merge(
                pack, batch, MERGE_CAP, fill=fill), None))
            for name, form, call, into in runs:
                got = call()
                _agree({name: (into if into is not None else got,)},
                       (exp,), f"overlay_merge fill={fill} Cb={cb} {form}")
                del got
            for name, form, call, _ in runs:
                ms = _device_ms(call, reps, KERNEL_HOLD_CYCLES, flush)
                print(json.dumps({
                    "row": "merge", "round": r, "tree": name, "form": form,
                    "fill": fill, "Cb": cb, "batch_live": nb,
                    "merged": merged, "device_ms": ms, "bound_ms": live_ms,
                    "rewrite_bound_ms": rewrite_ms}), flush=True)
            print(json.dumps({
                "row": "merge_split", "round": r, "fill": fill, "Cb": cb,
                **_kernel_split(lambda: own.overlay_merge(
                    pack, batch, MERGE_CAP, out=tgt, fill=fill,
                    out_fill=fill), reps, flush)}), flush=True)
            del pack, batch, exp, tgt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keys", type=int, default=20_000_000)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--queries", default=str(QUERIES),
                    help="comma-separated kernel batch sizes")
    ap.add_argument("--shards", type=int, default=0,
                    help="also time the sharded form over S range shards")
    ap.add_argument("--lm", action="store_true",
                    help="also time the kernel on an LM page table's mirror")
    ap.add_argument("--staged", action="store_true",
                    help="also time K5, K3 and K4 at each batch size on "
                         "the staged read's inputs")
    ap.add_argument("--merge", action="store_true",
                    help="also time K2 at each of MERGE_FILLS live entries "
                         "in a 2^24-slot pack and MERGE_BATCHES batch sizes")
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=SRC: time SRC/repro_torch's K1 (with "
                         "--staged its K3, K4 and K5, with --merge its K2)")
    args = ap.parse_args(argv)

    from ..core import Aulid, BlockDevice, partition_bulkload
    from ..core.device_index import build_device_index, stack_device_indexes
    from ..core.keys import keys_to_tensor
    from ..core.lookup import (device_arrays, overlay_from_numpy,
                               stacked_device_arrays)
    from ..core.workloads import make_dataset, payloads_for
    from ..device import resolve

    dev = resolve(args.device)
    cuda = dev.type == "cuda"
    trees = {}
    for spec in args.tree:
        name, src = spec.split("=", 1)
        trees[name] = _load_tree(f"_plain_tree_{name}", src)
    keys = make_dataset("covid", args.keys, seed=3)
    idx = Aulid(BlockDevice())
    idx.bulkload(keys, payloads_for(keys))
    di = build_device_index(idx)
    arrs = device_arrays(di, dev)
    h = max(di.max_inner_height, 3)
    cap = di.leaf_keys.shape[1]
    rng = np.random.default_rng(7)
    sizes = [int(x) for x in args.queries.split(",")]
    qs = {Q: keys_to_tensor(_queries(rng, keys, Q), dev) for Q in sizes}
    qt = keys_to_tensor(_queries(rng, keys, QUERIES), dev)
    cases = {"no overlay": None,
             "overlay": overlay_from_numpy(
                 _served_pack(rng, keys), dev)}
    card = torch.cuda.get_device_name(dev) if cuda else "cpu"
    print(json.dumps({"device": card, "keys": args.keys, "queries": sizes,
                      "height": h, "leaf_cap": cap, "overlay_cap": OV_CAP,
                      "trees": list(trees)}),
          flush=True)
    first = next(iter(trees.values()))
    ref = first.k1.lookup_plain(arrs, cases["overlay"], qt, h)
    _agree({n: t.k1.lookup_plain(arrs, cases["overlay"], qt, h)
            for n, t in trees.items()}, ref, "lookup_plain")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev) \
        if cuda else None
    order = list(trees)
    for r in range(ROUNDS):
        if cuda:
            _sweep(trees, "fused_lookup", arrs, cases, qs, h, flush, r,
                   args.reps, cap)
        for name in (order if r % 2 == 0 else order[::-1]):
            ops = trees[name].k1
            for case, ovr in cases.items():
                def fn():
                    return ops.lookup_plain(arrs, ovr, qt, h)
                fn()
                out = {"row": "plain", "round": r, "tree": name,
                       "case": case, "Q": QUERIES,
                       "wall_ms": _wall_ms(fn, args.reps, cuda),
                       "aten_ops": _aten_ops(fn)}
                if cuda:
                    out["device_ms"] = _device_ms(fn, args.reps)
                print(json.dumps(out), flush=True)
    if not cuda:
        return 0
    if args.lm:
        lm_arrs, lm_keys, lm_h = _lm_case(dev)
        lm_q = {lm_keys.shape[0]: keys_to_tensor(lm_keys, dev)}
        lm_cap = lm_arrs["leaf_keys"].shape[1]
        for r in range(ROUNDS):
            _sweep(trees, "fused_lookup", lm_arrs, {"lm": None}, lm_q, lm_h,
                   flush, r, args.reps * 2, lm_cap)
    if args.staged:
        from ..kernels.inner_probe.ops import ProbeIndex
        pi = ProbeIndex(arrs, di.inner_height)
        k5_in, k4_in = _staged_inputs(pi, qs), _k4_inputs(pi, qs, keys)
        print(json.dumps({"k4_widths": {
            n: v[0].shape[1] for n, v in k4_in[sizes[0]].items()}}),
              flush=True)
        for r in range(ROUNDS):
            _staged_sweep(trees, arrs, cases["overlay"], qs, k5_in, k4_in,
                          flush, r, args.reps)
    if args.merge:
        for r in range(ROUNDS):
            _merge_sweep(trees, flush, r, args.reps)
    if args.shards:
        del arrs, di, idx
        torch.cuda.empty_cache()
        part = partition_bulkload(keys, payloads_for(keys), args.shards)
        sdi = stack_device_indexes(
            [build_device_index(sh) for sh in part.shards], part.bounds)
        stk = stacked_device_arrays(sdi, device=dev)
        sh = max(sdi.max_inner_height, 3)
        print(json.dumps({"shards": args.shards, "height": sh,
                          "leaf_pool": list(sdi.leaf_keys.shape)}),
              flush=True)
        for r in range(ROUNDS):
            _sweep(trees, "fused_lookup_sharded", stk, cases, qs, sh, flush,
                   r, args.reps, sdi.leaf_keys.shape[2],
                   stk["bounds"].numel())
    return 0


if __name__ == "__main__":
    sys.exit(main())
