#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the AULID serving engine on one CUDA card.

    python3 chip_smoke.py            # 200M keys, 50 steps, not cut

Phases (any failure raises, so the exit code is non-zero and no result is
printed):

1. card and build: the ``nvidia-smi`` name/power-limit line; both CUDA
   kernels built from ``src/repro_torch/csrc`` (one nvcc each, in
   parallel) with ptxas' register and spill report;
2. kernel == plain version, exactly, on the card: K1 ``fused_lookup`` on
   four 200k-key mirrors of the scaled 512-B geometry and a 20M-key ``osm``
   mirror of the default geometry, each without and with an overlay of
   upserts and tombstones; K2 ``overlay_merge`` on random packs (empty,
   all-overlap, tombstones, cap growth, Ca = 2^24 with Cb = 512);
3. the main path: ``IndexEngine`` serving 200M covid-like keys (payload =
   key + 1, default 4 KB geometry — the paper's evaluation size) for 50
   steps of 8192 gets (10% absent), 512 writes (60% new-key inserts, 30%
   updates, 10% deletes) and 16 scans of 100, every result checked against
   a host oracle (the sorted keys plus a dict of the writes); the kernels'
   launch counts are read around exactly this run; then a few more steps
   of the same traffic, timed phase by phase (the step's breakdown);
4. compaction on the card: 1M keys at gamma = 0.001, synchronous and
   background compactions, results checked the same way;
5. the numbers: K1/K2 held once more against their plain versions on the
   main path's own tensors, then both timed with CUDA events at those
   shapes (median launch; L2 flushed before each launch), their bytes
   bounds, steps/s, p99 step time and peak device memory, each beside the
   card's name and power limit; then the ``kernels`` line and, last,
   ``{"ok": true, "device": {...}}``.

It exits non-zero without CUDA and when run outside a checkout of the
repository (it imports the port from ``src/`` beside it).
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak (NVIDIA data sheet)
# the main path: the AULID paper's evaluation size (arXiv 2306.02604, §5.1)
MAIN_KEYS = 200_000_000
MAIN_STEPS = 50
GEOM_512B = dict(block_bytes=512, leaf_capacity=32, mixed_slots_per_block=16,
                 pa_classes=(4, 8, 16), bt_max_children=4,
                 bt_child_capacity=7)
# K1 parity mirrors: (dataset, keys, AulidConfig geometry, label)
K1_MIRRORS = [(d, 200_000, GEOM_512B, "512b")
              for d in ("covid", "planet", "genome", "osm")] \
    + [("osm", 20_000_000, {}, "4k")]
K1_SOURCE = "src/repro_torch/csrc/fused_lookup.cu"
K2_SOURCE = "src/repro_torch/csrc/overlay_merge.cu"
K1_REPLACES = "src/repro/kernels/fused_lookup/fused_lookup.py:296"
K2_REPLACES = "src/repro/kernels/overlay_merge/overlay_merge.py:108"


def log(*a) -> None:
    print(*a, flush=True)


# ------------------------------------------------------------------- phase 1
def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build("fused_lookup", "overlay_merge")
    log(f"build: both kernels in {time.perf_counter() - t0:.3f} s")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"ptxas[{name}]: {line.strip()}")


# ------------------------------------------------------------------- phase 2
class Parity:
    """Kernel-vs-plain comparisons; launches made here are not counted as
    main-path launches (the counters are reset before the main path)."""

    def __init__(self):
        self.cases = {"fused_lookup": 0, "overlay_merge": 0}
        self.err = {"fused_lookup": 0.0, "overlay_merge": 0.0}

    def hold(self, name: str, got, exp) -> None:
        import torch
        torch.cuda.synchronize()
        for g, e in zip(got, exp):
            if not torch.equal(g, e):
                bad = int((g != e).sum())
                raise AssertionError(f"{name}: kernel != plain version at "
                                     f"{bad} of {g.numel()} entries")
            d = (g.to(torch.float64) - e.to(torch.float64)).abs().max()
            self.err[name] = max(self.err[name], float(d))
        self.cases[name] += 1


def _queries(keys: np.ndarray, rng, n_hit: int, n_miss: int) -> np.ndarray:
    """Present, absent, below-min, above-max and padding keys."""
    edges = np.array([0, max(int(keys[0]) - 1, 0), int(keys[0]),
                      int(keys[-1]), int(keys[-1]) + 1, 2**63, 2**64 - 2,
                      2**64 - 1], dtype=np.uint64)
    return np.concatenate([rng.choice(keys, n_hit),
                           rng.integers(0, 2**64 - 1, n_miss,
                                        dtype=np.uint64), edges])


def k1_parity(par: Parity, dev) -> None:
    from repro_torch.core import Aulid, AulidConfig, BlockDevice, DeltaOverlay
    from repro_torch.core import lookup as L
    from repro_torch.core.device_index import build_device_index
    from repro_torch.core.keys import keys_to_tensor
    from repro_torch.core.workloads import make_dataset, payloads_for
    from repro_torch.kernels.fused_lookup.ops import fused_lookup, lookup_plain

    for name, n, geom, tag in K1_MIRRORS:
        t0 = time.perf_counter()
        keys = make_dataset(name, n, seed=1)
        idx = Aulid(BlockDevice(block_bytes=geom.get("block_bytes", 4096)),
                    cfg=AulidConfig(**geom))
        idx.bulkload(keys, payloads_for(keys))
        di = build_device_index(idx)
        h = max(di.max_inner_height, 3)
        tags = np.bincount(di.slot_tag, minlength=5).tolist()
        rng = np.random.default_rng(n)
        ov = DeltaOverlay()
        for k in rng.integers(0, 2**62, 2000, dtype=np.uint64):
            ov.record_insert(int(k), int(k) % 1009)
        for k in rng.choice(keys, 2000):
            ov.record_insert(int(k), int(k) + 77)
        for k in rng.choice(keys, 2000):
            ov.record_delete(int(k))
        arrs = L.device_arrays(di, dev)
        q = keys_to_tensor(_queries(keys, rng, 6000, 2000), dev)
        for ovr in (None, L.overlay_arrays(ov, dev)):
            got = fused_lookup(arrs, ovr, q, h)
            par.hold("fused_lookup", got, lookup_plain(arrs, ovr, q, h))
        log(f"k1 parity {name}-{tag} n={len(keys)} height={di.inner_height} "
            f"slot tags NULL/DATA/PA/BT/MIXED={tags}: exact "
            f"({time.perf_counter() - t0:.3f} s)")
        del arrs, idx, di


def _pack(rng, keys, cap: int) -> np.ndarray:
    keys = np.sort(np.asarray(keys, dtype=np.uint64))
    n = keys.shape[0]
    pack = np.zeros((3, cap), dtype=np.uint64)
    pack[0] = np.uint64(2**64 - 1)
    pack[0, :n] = keys
    pack[1, :n] = rng.integers(0, 2**63, n, dtype=np.uint64)
    pack[2, :n] = rng.random(n) < 0.25
    return pack


def k2_parity(par: Parity, dev) -> None:
    from repro_torch.core.lookup import overlay_from_numpy
    from repro_torch.kernels.overlay_merge.ops import (
        merge_overlay_pack_torch, overlay_merge)
    rng = np.random.default_rng(2)
    pool = rng.choice(2**62, size=1_200_000, replace=False).astype(np.uint64)
    cases = [
        ("empty", _pack(rng, [], 1024), _pack(rng, pool[:300], 512), 1024),
        ("all-overlap", _pack(rng, pool[:512], 1024),
         _pack(rng, pool[:512], 512), 1024),
        ("tombstones", _pack(rng, pool[:5000], 8192),
         _pack(rng, pool[4800:5300], 512), 8192),
        ("cap-growth", _pack(rng, pool[:4000], 4096),
         _pack(rng, pool[3900:4400], 512), 8192),
        ("ca=2^24,cb=512", _pack(rng, pool[:1_000_000], 1 << 24),
         _pack(rng, np.concatenate([pool[999_800:1_000_000],
                                    pool[1_100_000:1_100_312]]), 512),
         1 << 24),
    ]
    for name, a, b, cap_out in cases:
        pa = overlay_from_numpy(a, dev)["ov_pack"]
        pb = overlay_from_numpy(b, dev)["ov_pack"]
        got = overlay_merge(pa, pb, cap_out)
        par.hold("overlay_merge", (got,),
                 (merge_overlay_pack_torch(pa, pb, cap_out),))
        log(f"k2 parity {name}: Ca={a.shape[1]} Cb={b.shape[1]} "
            f"cap_out={cap_out}: exact")


# ------------------------------------------------------------- phases 3 and 4
class Oracle:
    """The served view on the host: the sorted bulkloaded keys (payload =
    key + 1) plus a dict of every write since (payload, or None when
    deleted)."""

    def __init__(self, keys: np.ndarray):
        self.keys = keys
        self.writes: dict[int, int | None] = {}
        self.deletes = 0

    def write(self, op: str, key: int, payload: int) -> None:
        if op == "delete":
            self.writes[key] = None
            self.deletes += 1
        else:
            self.writes[key] = payload

    def gets(self, qs: np.ndarray) -> list:
        keys = self.keys
        pos = np.minimum(np.searchsorted(keys, qs), keys.shape[0] - 1)
        base = keys[pos] == qs
        out = []
        for k, b in zip(qs.tolist(), base.tolist()):
            if k in self.writes:
                out.append(self.writes[k])
            else:
                out.append(k + 1 if b else None)
        return out

    def scan(self, start: int, count: int, wkeys: np.ndarray) -> list:
        i = int(np.searchsorted(self.keys, np.uint64(start)))
        cand = self.keys[i: i + count + self.deletes]
        view = {k: k + 1 for k in cand.tolist()}
        hi = int(cand[-1]) if cand.shape[0] == count + self.deletes \
            else 2**64
        lo_w = int(np.searchsorted(wkeys, np.uint64(start)))
        hi_w = int(np.searchsorted(wkeys, np.uint64(min(hi, 2**64 - 1)),
                                   side="right"))
        for k in wkeys[lo_w:hi_w].tolist():
            v = self.writes[k]
            if v is None:
                view.pop(k, None)
            else:
                view[k] = v
        return sorted(view.items())[:count]


def make_step(rng, keys: np.ndarray, lo: int, hi: int, gets: int,
              writes: int, scans: int) -> list:
    n_ins, n_upd = int(writes * 0.6), int(writes * 0.3)
    n_del = writes - n_ins - n_upd
    n_abs = gets // 10
    reqs = [("insert", int(k), int(k) % 1_000_003 + 7)
            for k in rng.integers(lo, hi, n_ins, dtype=np.uint64)]
    reqs += [("insert", int(k), int(k) * 3 % 2**61)
             for k in rng.choice(keys, n_upd)]
    reqs += [("delete", int(k)) for k in rng.choice(keys, n_del)]
    reqs += [("get", int(k)) for k in rng.choice(keys, gets - n_abs)]
    reqs += [("get", int(k)) for k in rng.integers(lo, hi, n_abs,
                                                   dtype=np.uint64)]
    reqs += [("scan", int(k), 0, 100) for k in rng.choice(keys, scans)]
    return reqs


def serve_and_check(eng, oracle: Oracle, trace: list) -> None:
    """Run every step of ``trace`` through ``eng`` and check each result
    against the oracle (the checks sit outside the engine's step timer)."""
    for si, step in enumerate(trace):
        reqs = [eng.submit(*r) for r in step]
        eng.step()
        for r in reqs:
            if r.op in ("insert", "delete"):
                exp = True if r.op == "insert" else (
                    oracle.gets(np.array([r.key], np.uint64))[0] is not None)
                if r.result != exp:
                    raise AssertionError(f"step {si}: {r.op} {r.key} -> "
                                         f"{r.result}, want {exp}")
                oracle.write(r.op, r.key, r.payload)
        got = [r for r in reqs if r.op == "get"]
        exp = oracle.gets(np.array([r.key for r in got], dtype=np.uint64))
        bad = [(r.key, r.result, e) for r, e in zip(got, exp) if r.result != e]
        if bad:
            raise AssertionError(f"step {si}: {len(bad)} wrong gets, "
                                 f"first {bad[:3]}")
        wkeys = np.array(sorted(oracle.writes), dtype=np.uint64)
        for r in (r for r in reqs if r.op == "scan"):
            exp = oracle.scan(r.key, r.count, wkeys)
            if r.result != exp:
                raise AssertionError(f"step {si}: scan {r.key} differs")


def main_path(n: int, steps: int, dev, card: str) -> dict:
    import torch
    from repro_torch.core import Aulid, BlockDevice
    from repro_torch.core.workloads import make_dataset, payloads_for
    from repro_torch.kernels.fused_lookup.ops import fused_lookup
    from repro_torch.kernels.overlay_merge.ops import overlay_merge
    from repro_torch.serving import IndexEngine

    log(f"main path: {n} keys, {steps} steps (not cut)")
    t0 = time.perf_counter()
    keys = make_dataset("covid", n, seed=0)
    t1 = time.perf_counter()
    idx = Aulid(BlockDevice())
    idx.bulkload(keys, payloads_for(keys))
    t2 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    eng = IndexEngine(idx, device=dev)        # gamma = 0.05
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    log(f"main path set-up: {n} keys made in {t1 - t0:.3f} s, bulkloaded in "
        f"{t2 - t1:.3f} s, mirrored to {eng.device} in {t3 - t2:.3f} s "
        f"(leaf pool {tuple(eng.arrs['leaf_keys'].shape)}, inner height "
        f"{eng.di.inner_height}, overlay pack "
        f"{tuple(eng.ov_arrs['ov_pack'].shape)})")
    rng = np.random.default_rng(7)
    lo, hi = int(keys[0]), int(keys[-1]) + 1
    trace = [make_step(rng, keys, lo, hi, 8192, 512, 16)
             for _ in range(steps)]
    oracle = Oracle(keys)
    fused_lookup.launches = 0
    overlay_merge.launches = 0
    serve_and_check(eng, oracle, trace)
    launches = {"fused_lookup": fused_lookup.launches,
                "overlay_merge": overlay_merge.launches}
    st = eng.stats()
    step_s = np.asarray(eng.step_seconds)
    out = {
        "card": card, "keys": n, "steps": st["steps"],
        "requests": sum(len(s) for s in trace),
        "steps_per_s": st["steps"] / eng.serve_seconds,
        "p99_step_ms": float(np.percentile(step_s, 99)) * 1e3,
        "p50_step_ms": float(np.percentile(step_s, 50)) * 1e3,
        "first_step_ms": float(step_s[0]) * 1e3,
        "p99_step_ms_after_first_2": float(np.percentile(step_s[2:], 99))
        * 1e3,
        "max_memory_allocated_bytes": int(torch.cuda.max_memory_allocated()),
        "overlay_merges": st["overlay_merges"],
        "compactions": st["compactions"],
        "read_backend": st["read_backend"],
        "launches": launches,
        "checked": "every get, write and scan result equals the oracle",
    }
    log("main path: " + json.dumps(out))
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"{k} was not launched on the main path")
    return {"engine": eng, "trace": trace, "launches": launches,
            "summary": out, "oracle": oracle, "keys": keys, "span": (lo, hi)}


def breakdown(mp: dict, steps: int) -> dict:
    """Serve ``steps`` more main-path steps with the engine's phases timed
    on the host clock (device phases end in a synchronize): mean seconds per
    step in host writes, the overlay merge (batch upload + K2), gets (upload,
    K1, D2H, results) and scans; the rest is admission and bookkeeping."""
    import torch
    eng, oracle, keys = mp["engine"], mp["oracle"], mp["keys"]
    lo, hi = mp["span"]
    acc = {"host_writes": 0.0, "overlay_merge": 0.0, "gets": 0.0,
           "scans": 0.0}

    def timed(name, fn, sync):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            acc[name] += time.perf_counter() - t
            return out
        return run

    eng._apply_write = timed("host_writes", eng._apply_write, False)
    eng._after_writes = timed("overlay_merge", eng._after_writes, True)
    eng._serve_gets = timed("gets", eng._serve_gets, True)
    eng._serve_scans = timed("scans", eng._serve_scans, True)
    rng = np.random.default_rng(13)
    n0 = len(eng.step_seconds)
    try:
        serve_and_check(eng, oracle, [make_step(rng, keys, lo, hi, 8192, 512,
                                                16) for _ in range(steps)])
    finally:
        for name in ("_apply_write", "_after_writes", "_serve_gets",
                     "_serve_scans"):
            delattr(eng, name)
    step_s = float(np.sum(eng.step_seconds[n0:])) / steps
    out = {k: v / steps for k, v in acc.items()}
    out["other"] = step_s - sum(out.values())
    out["step"] = step_s
    log("step breakdown (s per step): " + json.dumps(out))
    return out


def compaction_phase(dev) -> None:
    from repro_torch.core import Aulid, BlockDevice
    from repro_torch.core.workloads import make_dataset, payloads_for
    from repro_torch.serving import IndexEngine
    keys = make_dataset("covid", 1_000_000, seed=3)
    lo, hi = int(keys[0]), int(keys[-1]) + 1
    for mode in ("sync", "async"):
        idx = Aulid(BlockDevice())
        idx.bulkload(keys, payloads_for(keys))
        eng = IndexEngine(idx, device=dev, gamma=0.001,
                          async_compact=mode == "async")
        rng = np.random.default_rng(11)
        oracle = Oracle(keys)
        for i in range(8):
            serve_and_check(eng, oracle,
                            [make_step(rng, keys, lo, hi, 1024, 512, 8)])
            if i % 2:       # let every second step's build land
                eng.drain_compactions()
        serve_and_check(eng, oracle, [make_step(rng, keys, lo, hi, 1024, 0,
                                                8)])
        st = eng.stats()
        log(f"compaction {mode}: compactions={st['compactions']} "
            f"swaps={st['swaps']} full_builds={st['mirror_full_builds']} "
            f"overlay_merges={st['overlay_merges']} "
            f"reseeds={st['overlay_reseeds']}: every result checked")
        if st["compactions"] < 2 or (mode == "async" and st["swaps"] < 2):
            raise AssertionError(f"compaction {mode}: too few compactions")


# ------------------------------------------------------------------- phase 5
def time_cuda(fn, reps: int, flush) -> np.ndarray:
    """ms of each of ``reps`` launches of ``fn``, each timed by CUDA events
    after a write of ``flush`` evicted L2."""
    import torch
    fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return np.array([a.elapsed_time(b) for a, b in evs])


def measure(mp: dict, par: Parity, dev) -> list:
    import torch
    from repro_torch.core.keys import (BIASED_MAX, keys_from_tensor,
                                       keys_to_tensor)
    from repro_torch.core.lookup import overlay_from_numpy
    from repro_torch.kernels.fused_lookup.ops import fused_lookup, lookup_plain
    from repro_torch.kernels.overlay_merge.ops import (
        merge_overlay_pack_torch, overlay_merge)
    from repro_torch.serving import pad_queries

    eng = mp["engine"]
    arrs, ovr, h = eng.arrs, eng.ov_arrs, eng._height()
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    # K1 at the main path's shape: the last step's get batch
    gets = [r[1] for r in mp["trace"][-1] if r[0] == "get"]
    q = keys_to_tensor(pad_queries(gets), dev)
    Q = q.shape[0]
    got = fused_lookup(arrs, ovr, q, h)
    par.hold("fused_lookup", got, lookup_plain(arrs, ovr, q, h))
    log(f"k1 parity main path (200M-key mirror, Q={Q}, overlay "
        f"{tuple(ovr['ov_pack'].shape)}): exact")
    k1_ms = time_cuda(lambda: fused_lookup(arrs, ovr, q, h), 50, flush)
    k1_plain = time_cuda(lambda: lookup_plain(arrs, ovr, q, h), 10, flush)
    spread = {"fused_lookup": k1_ms}
    leaf = got[2]
    C = arrs["leaf_keys"].shape[1]
    rows = int(torch.unique(leaf).numel())
    # bytes K1 must move: queries in, outputs out, each distinct leaf row's
    # keys once, one payload word per query, and at least one inner slot
    # entry (next_occ, key, tag, ptr) and one overlay key per query
    k1_bytes = Q * 8 + Q * 13 + rows * C * 8 + Q * 8 + Q * 28
    # K2 at the main path's shape: the served pack and a 512-entry batch
    pack = ovr["ov_pack"]
    live = int((pack[0] != BIASED_MAX).sum())
    rng = np.random.default_rng(5)
    live_keys = keys_from_tensor(pack[0, :live]) if live else \
        np.empty(0, np.uint64)
    fresh = rng.integers(1_500_000_000_000, 1_700_000_000_000, 512,
                         dtype=np.uint64)
    if live:
        fresh[:150] = rng.choice(live_keys, 150)
    bnp = _pack(rng, np.unique(fresh), 512)
    batch = overlay_from_numpy(bnp, dev)["ov_pack"]
    cap_out = pack.shape[1]
    par.hold("overlay_merge", (overlay_merge(pack, batch, cap_out),),
             (merge_overlay_pack_torch(pack, batch, cap_out),))
    log(f"k2 parity main path (served pack, live {live}, Cb="
        f"{batch.shape[1]}): exact")
    k2_ms = time_cuda(lambda: overlay_merge(pack, batch, cap_out), 20, flush)
    k2_plain = time_cuda(lambda: merge_overlay_pack_torch(pack, batch,
                                                          cap_out), 5, flush)
    spread["overlay_merge"] = k2_ms
    for name, t in spread.items():
        log(f"{name} launch times (ms): min {t.min()} p50 {np.median(t)} "
            f"max {t.max()} over {t.size} launches")
    nb = int((batch[0] != BIASED_MAX).sum())
    k2_bytes = 24 * (live + nb) + 24 * cap_out
    log(f"timing shapes: K1 Q={Q} height={h} leaf rows={rows} overlay "
        f"cap={pack.shape[1]} (live {live}); K2 Ca={pack.shape[1]} "
        f"Cb={batch.shape[1]} cap_out={cap_out}")
    return [
        {"name": "fused_lookup", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES,
         "launches": mp["launches"]["fused_lookup"],
         "max_abs_err": par.err["fused_lookup"],
         "ms": float(np.median(k1_ms)), "mean_ms": float(k1_ms.mean()),
         "plain_ms": float(np.median(k1_plain)),
         "bound_ms": k1_bytes / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": None, "parity": "exact",
         "cases": par.cases["fused_lookup"]},
        {"name": "overlay_merge", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES,
         "launches": mp["launches"]["overlay_merge"],
         "max_abs_err": par.err["overlay_merge"],
         "ms": float(np.median(k2_ms)), "mean_ms": float(k2_ms.mean()),
         "plain_ms": float(np.median(k2_plain)),
         "bound_ms": k2_bytes / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": None, "parity": "exact",
         "cases": par.cases["overlay_merge"]},
    ]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    build_kernels()
    par = Parity()
    k1_parity(par, dev)
    k2_parity(par, dev)
    mp = main_path(MAIN_KEYS, MAIN_STEPS, dev, card)
    mp["summary"]["breakdown_s"] = breakdown(mp, 5)
    compaction_phase(dev)
    kernels = measure(mp, par, dev)
    for k in kernels:
        log(f"{k['name']} on {card}: median launch {k['ms']} ms (mean "
            f"{k['mean_ms']} ms; plain median {k['plain_ms']} ms,"
            f" bound {k['bound_ms']} ms by {k['bound_by']}), "
            f"{k['launches']} launches on the main path")
    s = mp["summary"]
    log(f"end to end on {card}: {s['steps_per_s']} steps/s, p99 step "
        f"{s['p99_step_ms']} ms, peak device memory "
        f"{s['max_memory_allocated_bytes']} bytes; total "
        f"{time.perf_counter() - t_start:.3f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
