#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the AULID serving engine on one CUDA card.

    python3 chip_smoke.py      # 200M keys, 50 steps (30 in 8 shards), not cut

Phases (any failure raises, so the exit code is non-zero and no result is
printed):

1. card and build: the ``nvidia-smi`` name/power-limit line; all six CUDA
   kernels built from ``src/repro_torch/csrc`` (one nvcc each, in
   parallel) with ptxas' register and spill report (each kernel's
   registers, static shared memory and spills under ``ptxas`` in its
   ``kernels`` entry, K1's shared-memory plan under ``plan``);
2. kernel == plain version, exactly, on the card: K1 ``fused_lookup`` on
   four 200k-key mirrors of the scaled 512-B geometry and a 20M-key ``osm``
   mirror of the default geometry, each without and with an overlay of
   upserts and tombstones; on the same mirrors and queries (edge keys up
   to ``2**64-1`` included) K5 ``inner_probe`` (root predictions and random
   slots), K4 ``leaf_search`` (K1's leaf rows and PA rows), K3
   ``overlay_probe`` (an empty overlay and one with tombstones), and the
   staged read ``inner_probe_lookup`` against K1 on found and found
   payloads; K4 on full rows (rank == C) and K3 on a full pack; K2
   ``overlay_merge`` on random packs (empty, all-overlap, tombstones, cap
   growth, Ca = 2^24 with Cb = 512); K1's shard route
   (``fused_lookup_sharded``) on stacks of the same datasets (200k keys in
   1, 3 and 8 shards and in 5 shards padded to 8 slots; the 20M-key osm
   mirror in 8 shards), queries at every bound +- 1, without and with an
   overlay; K2's stacked form (``overlay_merge_stacked``) on 8 rows of
   every kind and on 8 rows of Ca = cap_out = 2^21 with Cb = 64, timed;
3. the main path: ``IndexEngine`` serving 200M covid-like keys (payload =
   key + 1, default 4 KB geometry — the paper's evaluation size) for 50
   steps of 8192 gets (10% absent), 512 writes (60% new-key inserts, 30%
   updates, 10% deletes) and 16 scans of 100, every result checked against
   a host oracle (the sorted keys plus a dict of the writes); the kernels'
   launch counts are read around exactly this run; then a few more steps
   of the same traffic, timed phase by phase (the step's breakdown);
4. compaction on the card: 1M keys at gamma = 0.001, synchronous and
   background compactions, results checked the same way; then the
   ``ShardedIndexEngine``'s maintenance at 1M keys in 8 shards, sync and
   async answering alike: shard-local compaction (only the hot shard
   compacts, cold shards keep their mirror epochs) and online
   repartitioning (drift inserts until the load monitor splits, then a
   merge forced by hand), with no compaction, split or merge build
   failed;
5. the numbers: K1/K2 held once more against their plain versions on the
   main path's own tensors, then both timed with CUDA events at those
   shapes (median launch; L2 flushed and the stream held before each
   launch, long enough for a plain version's hundreds of launches too, so
   ``ms`` and ``plain_ms`` are the device's time alone), their bytes
   bounds, steps/s, p99 step time and peak device memory, each beside the
   card's name and power limit;
6. the staged read on the main path's mirror and served overlay pack: the
   last step's 8192 gets through ``inner_probe_lookup`` (K5 rounds, K4 on
   PA/BT and leaf rows) and ``overlay_probe`` (K3), with the launch counts
   read around exactly this run; its snapshot answers equal K1's, its
   merged answers the host oracle's; every K3/K4/K5 launch of that run
   held against its plain version on the tensors it launched on, each
   kernel timed like K1/K2 (``torch.searchsorted`` beside K3, and beside
   K4 over the rows gathered beforehand), K4's bound counted from the
   fewest sectors a search of its rows reads at any lanes a query
   (``k4_least_sectors``) with the whole-row bound beside it, and the
   whole staged batch timed on the host clock beside K1's read of the same
   batch;
6a. the sharded path, after the monolithic engine is freed: the main
   path's 200M keys in 8 range shards (``partition_bulkload``, default
   geometry) served by ``ShardedIndexEngine`` (gamma 0.05) for 30 steps of
   8192 gets (uniform, 10% absent), 512 writes (60% fresh inserts in the
   hot shard 4's range, 30% updates and 10% deletes over all shards) and
   16 scans of 100 (8 starting among the last 50 keys up to a bound), every
   result checked against the oracle, with the launch counts of K1's shard
   route, K2 and K2's stacked form read around exactly this run (the first
   two launched, the stacked form not: one card keeps one flat pack),
   every shard served and no background build failed; the step's
   breakdown and its device time (``torch.profiler``); K1's shard route
   held and timed on the run's own tensors beside the monolithic K1;
7. the LM serving path, after the index path's tensors are freed: the LM
   ``ServeEngine`` on the card held to the same engine on the CPU on a tiny
   config (equal tokens, logits within 1e-4); then qwen3-4b at full width
   (36 layers, d_model 2560, 32 heads over 8 kv heads of 128, vocab
   151,936; random float32 weights from a seeded ``torch.Generator``)
   serving 16 requests (prompts of 32-256 tokens, 16 new tokens each) in 8
   slots over a 512-page pool of 16-token pages, with the K1/K6 launch
   counts read around exactly that run; every K6 launch of its first 4
   steps held to ``paged_attention_plain`` on the tensors it launched on
   (float32, 1e-5), every page translation (K1) held to the host index,
   every request complete and every page reclaimed; the reference's
   empty-slot defect (ROADMAP Queue 3) counted; tokens/s, step times and
   their split into host work, translation, layers and head, peak memory;
   K1 held and timed on the page-table mirror and translation batch of
   step 200 (Q = 256, no overlay: the ``lm`` key of K1's entry);
   then, with a fresh batch in every slot, device time by kernel over 8
   steady steps at rows of 89-96 tokens (``torch.profiler``; K6's split
   and combine kernels summed) and the device's busy share;
8. K6 alone at the served decode shape (8 rows of 89-96 tokens, 32 pages
   a row, a shuffled 512-page pool of one qwen3-4b layer) and at a
   long-context one (16 rows of 2048-4096 tokens, 256 pages a row, a
   shuffled 4096-page pool), float32 and bfloat16: held to its plain
   version (a row of length 0 and one of every token included), timed like
   K1 beside its plain version and ``scaled_dot_product_attention`` on the
   same KV gathered contiguous (the gather not timed); then the
   ``kernels`` line (K6's long-context numbers, its served ones under
   ``served``; K1's shard route under K1's ``sharded``, K2's stacked form
   under K2's ``stacked``) and, last, ``{"ok": true, "device": {...}}``.

It exits non-zero without CUDA and when run outside a checkout of the
repository (it imports the port from ``src/`` beside it).
"""
from __future__ import annotations

import gc
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

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
# the cfg.sharded branch of that kernel: the route and per-shard offsets
K1S_REPLACES = "src/repro/kernels/fused_lookup/fused_lookup.py:140"
K2_REPLACES = "src/repro/kernels/overlay_merge/overlay_merge.py:108"
# the staged read's kernels: name -> (source, TPU kernel replaced)
STAGED = {
    "overlay_probe": ("src/repro_torch/csrc/overlay_probe.cu",
                      "src/repro/kernels/overlay_probe/overlay_probe.py:66"),
    "leaf_search": ("src/repro_torch/csrc/leaf_search.cu",
                    "src/repro/kernels/leaf_search/leaf_search.py:59"),
    "inner_probe": ("src/repro_torch/csrc/inner_probe.cu",
                    "src/repro/kernels/inner_probe/inner_probe.py:86"),
}
# K1's shard route and K2's stacked form, held against their plain versions
# under their own names (they build from K1's and K2's sources)
FORMS = ("fused_lookup_sharded", "overlay_merge_stacked")
# K1-sharded parity stacks at 200k keys, 512-B geometry: (live shards,
# slots); (5, 8) pads 5 live shards with placeholder slots
K1S_LAYOUTS = [(1, 0), (3, 0), (8, 0)]
K1S_PADDED = (5, 8)
K1S_KEYS, K1S_BIG_KEYS = 200_000, 20_000_000
# the sharded path: the main path's keys in 8 range shards
# (benchmarks/sharded_serving.py's NUM_SHARDS), its skewed trace scaled up
SHARDS = 8
SHARDED_STEPS = 30
MAINT_KEYS = 1_000_000
K6_SOURCE = "src/repro_torch/csrc/paged_attention.cu"
K6_REPLACES = "src/repro/kernels/paged_attention/paged_attention.py:77"
KERNELS = ("fused_lookup", "overlay_merge", *STAGED, "paged_attention")
# the LM serving path: qwen3-4b at full width, the engine's geometry
LM_ARCH = "qwen3-4b"
LM_ENGINE = dict(slots=8, page_size=16, n_pages=512, max_pages_per_seq=32)
LM_REQUESTS = 16
LM_PROMPT = (32, 256)            # prompt lengths, uniform, inclusive
LM_MAX_NEW = 16
LM_HELD_STEPS = 4                # steps whose every K6 launch is held
LM_PROFILED_STEPS = 8            # steps traced by torch.profiler
LM_K1_STEP = 200                 # the step whose translation K1 is timed on
# the traced steps' rows hold 89-96 tokens, about the served run's mean
LM_PROFILE_PROMPT, LM_PROFILE_WARM = 128, 88
K6_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# K6 alone: 16 rows of 2048-4096 tokens over a shuffled one-layer pool,
# and the served shape: 8 rows of 89-96 tokens over the engine's pool
K6_ROWS, K6_NP, K6_POOL = 16, 256, 4096
K6_SERVED_ROWS, K6_SERVED_LENS = 8, (89, 96)


def bound_ms(nbytes: int) -> float:
    """The time to move ``nbytes`` at the card's HBM peak, in ms."""
    from repro_torch.kernels.fused_lookup.ops import HBM_BYTES_PER_S
    return nbytes / HBM_BYTES_PER_S * 1e3


def log(*a) -> None:
    print(*a, flush=True)


# ------------------------------------------------------------------- phase 1
def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(text: str) -> dict:
    """One library's ptxas report summed over its entry functions (K6 has
    one a template instance): their count, the most registers and static
    shared memory of any, and the spill bytes of all."""
    import re
    used = re.findall(r"Used (\d+) registers[^\n]*", text)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        text)
    smem = [int(m) for m in re.findall(r"(\d+) bytes smem", text)]
    if not used or not spills:
        raise AssertionError(f"unreadable ptxas report:\n{text}")
    return {"entries": len(used),
            "registers": max(int(r) for r in used),
            "static_smem_bytes": max(smem, default=0),
            "spill_store_bytes": sum(int(a) for a, _ in spills),
            "spill_load_bytes": sum(int(b) for _, b in spills)}


def build_kernels() -> dict:
    """Build every kernel (one nvcc each, in parallel), log ptxas' report
    of every entry function and return each library's summary
    (:func:`ptxas_report`) by kernel name."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build(*KERNELS)
    log(f"build: {len(KERNELS)} kernels in {time.perf_counter() - t0:.3f} s")
    out = {}
    for name in KERNELS:
        text = _build.BUILD_LOG[name]
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"ptxas[{name}]: {line.strip()}")
        out[name] = ptxas_report(text)
        log(f"ptxas {name}: {json.dumps(out[name])}")
    return out


# ------------------------------------------------------------------- phase 2
class Parity:
    """Kernel-vs-plain comparisons; launches made here are not counted as
    main-path launches (the counters are reset before the main path)."""

    def __init__(self):
        self.cases = dict.fromkeys(KERNELS + FORMS, 0)
        self.err = dict.fromkeys(KERNELS + FORMS, 0.0)
        self.err_bf16 = dict.fromkeys(KERNELS, 0.0)

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


    def close(self, name: str, got, exp) -> None:
        """A float kernel's output within its dtype's tolerance (``K6_TOL``,
        absolute and relative) of its plain version's."""
        import torch
        torch.cuda.synchronize()
        dt = str(got.dtype).removeprefix("torch.")
        tol = K6_TOL[dt]
        if got.dtype != exp.dtype or got.shape != exp.shape:
            raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} "
                                 f"!= {exp.dtype} {tuple(exp.shape)}")
        g, e = got.double(), exp.double()
        d = (g - e).abs()
        if not bool((d <= tol + tol * e.abs()).all()) \
                or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version by up to {float(d.max())} "
                                 f"({dt}, tolerance {tol})")
        err = self.err_bf16 if dt == "bfloat16" else self.err
        err[name] = max(err[name], float(d.max()))
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
        ovr = L.overlay_arrays(ov, dev)
        for o in (None, ovr):
            got = fused_lookup(arrs, o, q, h)
            par.hold("fused_lookup", got, lookup_plain(arrs, o, q, h))
        staged_parity(par, arrs, ovr, di.inner_height, q, h, rng)
        log(f"k1/k3/k4/k5 parity {name}-{tag} n={len(keys)} height="
            f"{di.inner_height} slot tags NULL/DATA/PA/BT/MIXED={tags}: "
            f"exact; staged read == K1 ({time.perf_counter() - t0:.3f} s)")
        del arrs, idx, di


def staged_parity(par: Parity, arrs: dict, ovr: dict, inner_height: int,
                  q, h: int, rng) -> None:
    """K3/K4/K5 == their plain versions on one mirror's tensors, and the
    staged read == K1 on found and found payloads (snapshot and merged)."""
    import torch
    from repro_torch.core.keys import key_f64
    from repro_torch.core.lookup import empty_overlay_pack
    from repro_torch.kernels import ProbeIndex
    from repro_torch.kernels.fused_lookup.ops import fused_lookup
    from repro_torch.kernels.inner_probe import ops as k5
    from repro_torch.kernels.leaf_search import ops as k4
    from repro_torch.kernels.overlay_probe import ops as k3

    Q, dev = q.shape[0], q.device
    S = arrs["slot_tag"].shape[0]
    pi = ProbeIndex(arrs, inner_height)
    for s in (pi.predict(torch.zeros_like(q), key_f64(q)),
              torch.from_numpy(rng.integers(0, S, Q).astype(np.int32)
                               ).to(dev)):
        par.hold("inner_probe", k5.probe_level(arrs, s, q),
                 k5.probe_level_plain(arrs, s, q))
    _, _, leaf = fused_lookup(arrs, None, q, h)
    npa = arrs["pa_keys"].shape[0]
    pa_rows = torch.from_numpy(rng.integers(0, npa, Q).astype(np.int32)
                               ).to(dev)
    for keys, pay, rows in ((arrs["leaf_keys"], arrs["leaf_pay"], leaf),
                            (arrs["pa_keys"], pi.pa_pay, pa_rows)):
        par.hold("leaf_search", k4.leaf_search(keys, pay, rows, q),
                 k4.leaf_search_plain(keys, pay, rows, q))
    empty = {"ov_pack": empty_overlay_pack(1024, dev)}
    for o in (empty, ovr):
        par.hold("overlay_probe", k3.overlay_probe(o, q),
                 k3.overlay_probe_plain(o, q))
    for o in (None, ovr):
        pay, found = _staged_read(pi, o, q)
        k1_pay, k1_found, _ = fused_lookup(arrs, o, q, h)
        torch.cuda.synchronize()
        if not (torch.equal(found, k1_found)
                and torch.equal(torch.where(found, pay, 0), k1_pay)):
            raise AssertionError("staged read != K1 on "
                                 f"{int((found != k1_found).sum())} found "
                                 "flags or on found payloads")


def _staged_read(pi, ovr, q, trace=None):
    """The staged read merged with K3 by the reference's rule
    (``src/repro/kernels/overlay_probe/ops.py:14-18``): hit & ~tomb -> the
    overlay payload, tomb -> a miss, else the snapshot.  (payload, found).
    ``trace`` collects each kernel call (``inner_probe_lookup``'s hook)."""
    import torch
    from repro_torch.kernels import inner_probe_lookup, overlay_probe
    pay, found = inner_probe_lookup(pi, q, trace=trace)
    if ovr is None:
        return pay, found
    opay, hit, tomb = overlay_probe(ovr, q)
    if trace is not None:
        trace.append(("overlay_probe", (ovr, q), (opay, hit, tomb)))
    return torch.where(hit & ~tomb, opay, pay), torch.where(hit, ~tomb, found)


def _check_oracle(oracle, qs: np.ndarray, pay, found) -> int:
    """The merged read of ``qs`` == the oracle's answers; returns the
    found count."""
    from repro_torch.core.keys import bits_from_tensor
    exp = oracle.gets(qs)
    got_f = found.cpu().numpy()
    got_p = bits_from_tensor(pay)
    bad = [i for i, e in enumerate(exp) if got_f[i] != (e is not None)
           or (e is not None and int(got_p[i]) != e)]
    if bad:
        raise AssertionError(f"staged read: {len(bad)} of {qs.size} keys "
                             f"differ from the oracle, first at "
                             f"{int(qs[bad[0]])}")
    return int(got_f.sum())


def k34_edge_parity(par: Parity, dev) -> None:
    """K4 on full rows (every query above its row: rank == C, payload 0),
    at batches that get 16, 8 and 4 lanes a query on an H100
    (``k4_lanes``), and K3 on a pack with no padding left (rank == cap)."""
    import torch
    from repro_torch.core.keys import keys_to_tensor
    from repro_torch.core.lookup import overlay_from_numpy
    from repro_torch.kernels.leaf_search import ops as k4
    from repro_torch.kernels.overlay_probe import ops as k3
    rng = np.random.default_rng(9)
    for C in (32, 256):
        keys = np.sort(rng.integers(0, 2**63, (4096, C), dtype=np.uint64),
                       axis=1)
        rows = rng.integers(0, 4096, 8192).astype(np.int32)
        q = keys[rows, -1] + np.uint64(1)
        q[::2] = keys[rows[::2], rng.integers(0, C, 4096)]
        kt = keys_to_tensor(keys.reshape(-1), dev).reshape(keys.shape)
        pt = torch.from_numpy(keys.view(np.int64) ^ 77).to(dev)
        rt, qt = torch.from_numpy(rows).to(dev), keys_to_tensor(q, dev)
        for Q in (1000, 3000, 8192):
            got = k4.leaf_search(kt, pt, rt[:Q], qt[:Q])
            par.hold("leaf_search", got,
                     k4.leaf_search_plain(kt, pt, rt[:Q], qt[:Q]))
            if got[1][1::2].any() or got[0][1::2].any() \
                    or not got[1][::2].all():
                raise AssertionError(f"leaf_search C={C} Q={Q}: rank == C "
                                     "misread")
    full = _pack(rng, rng.choice(2**62, 4096, replace=False), 4096)
    ovr = overlay_from_numpy(full, dev)
    q = keys_to_tensor(np.concatenate([full[0, :2048], np.array(
        [2**63, 2**64 - 2, 2**64 - 1], dtype=np.uint64)]), dev)
    par.hold("overlay_probe", k3.overlay_probe(ovr, q),
             k3.overlay_probe_plain(ovr, q))
    log("k3/k4 parity edge cases (rank == C, full pack): exact")


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


def _stacked(keys, shards: int, slots: int, geom: dict, dev):
    """(partition, stacked mirror, its tensors on ``dev``) of sorted
    ``keys`` in ``shards`` range shards, padded to ``slots`` slots."""
    from repro_torch.core import AulidConfig, partition_bulkload
    from repro_torch.core import lookup as L
    from repro_torch.core.device_index import (build_device_index,
                                               stack_device_indexes)
    from repro_torch.core.workloads import payloads_for
    part = partition_bulkload(keys, payloads_for(keys), shards,
                              cfg=AulidConfig(**geom))
    sdi = stack_device_indexes([build_device_index(sh) for sh in part.shards],
                               part.bounds, min_shards=slots)
    return part, sdi, L.stacked_device_arrays(sdi, device=dev)


def _bound_queries(keys, bounds, rng, n_hit: int, n_miss: int):
    """``_queries`` plus every bound and bound +- 1 (placeholder
    UINT64_MAX bounds included, where +1 does not exist)."""
    near = [int(b) + d for b in bounds for d in (-1, 0, 1)
            if 0 <= int(b) + d <= 2**64 - 1]
    return np.concatenate([_queries(keys, rng, n_hit, n_miss),
                           np.array(near, dtype=np.uint64)])


def k1_sharded_parity(par: Parity, dev) -> None:
    """K1's shard route == ``lookup_sharded_plain``, exactly, without and
    with an overlay, on stacks of the K1 parity datasets: the 512-B
    geometry at 200k keys in 1, 3 and 8 shards and in 5 shards padded to 8
    slots, and the 20M-key osm 4 KB mirror in 8 shards; routing equals the
    host partition's and no placeholder slot gets a query."""
    from repro_torch.core import DeltaOverlay
    from repro_torch.core import lookup as L
    from repro_torch.core.keys import keys_to_tensor
    from repro_torch.core.workloads import make_dataset
    from repro_torch.kernels.fused_lookup.ops import (fused_lookup_sharded,
                                                      lookup_sharded_plain)
    cases = [(d, K1S_KEYS, GEOM_512B, live, slots)
             for d in ("covid", "planet", "genome", "osm")
             for live, slots in K1S_LAYOUTS]
    cases += [("osm", K1S_KEYS, GEOM_512B, *K1S_PADDED),
              ("osm", K1S_BIG_KEYS, {}, SHARDS, 0)]
    made = {}
    for name, n, geom, live, slots in cases:
        t0 = time.perf_counter()
        if (name, n) not in made:
            made = {(name, n): make_dataset(name, n, seed=1)}
        keys = made[(name, n)]
        part, sdi, stk = _stacked(keys, live, slots, geom, dev)
        h = max(sdi.max_inner_height, 3)
        rng = np.random.default_rng(n + live)
        ov = DeltaOverlay()
        for k in rng.integers(0, 2**62, 2000, dtype=np.uint64):
            ov.record_insert(int(k), int(k) % 1009)
        for k in rng.choice(keys, 2000):
            ov.record_insert(int(k), int(k) + 77)
        for k in rng.choice(keys, 2000):
            ov.record_delete(int(k))
        qn = _bound_queries(keys, sdi.bounds, rng, 6000, 2000)
        q = keys_to_tensor(qn, dev)
        for o in (None, L.overlay_arrays(ov, dev)):
            got = fused_lookup_sharded(stk, o, q, h)
            par.hold("fused_lookup_sharded", got,
                     lookup_sharded_plain(stk, o, q, h))
        sid = got[3].cpu().numpy()
        if not (sid == part.shard_of_batch(qn)).all() or sid.max() >= live:
            raise AssertionError(f"k1 sharded {name}: route != the host "
                                 "partition's")
        tags = np.bincount(sdi.slot_tag.reshape(-1), minlength=5).tolist()
        log(f"k1 sharded parity {name}-{'4k' if not geom else '512b'} "
            f"n={n} shards={live} slots={sdi.num_shards} height={h} slot "
            f"tags={tags} queries={qn.size} (every bound +-1): exact, route "
            f"== host ({time.perf_counter() - t0:.3f} s)")
        del stk, sdi, part


def k2_stacked_parity(par: Parity, dev, card: str) -> dict:
    """K2's stacked form == its plain version, exactly: 8 rows of every
    kind (empty rows, all-overlap, tombstones, cap growth), then 8 rows of
    Ca = cap_out = 2^21 with Cb = 64 (the bytes of the served flat pack),
    timed like K1/K2 beside its plain version."""
    import torch
    from repro_torch.core.keys import BIASED_MAX
    from repro_torch.core.lookup import overlay_from_numpy
    from repro_torch.kernels.overlay_merge.ops import (
        merge_overlay_stacked_torch, overlay_merge_stacked)
    rng = np.random.default_rng(4)
    pool = rng.choice(2**62, size=2_600_000, replace=False).astype(np.uint64)

    def stack(rows):
        return torch.stack([overlay_from_numpy(r, dev)["ov_pack"]
                            for r in rows])
    rows = [(_pack(rng, [], 8192), _pack(rng, pool[:300], 512)),
            (_pack(rng, pool[:512], 8192), _pack(rng, pool[:512], 512)),
            (_pack(rng, pool[:5000], 8192), _pack(rng, pool[4800:5300], 512)),
            (_pack(rng, pool[:7900], 8192), _pack(rng, pool[7800:8100], 512)),
            (_pack(rng, pool[:100], 8192), _pack(rng, [], 512)),
            (_pack(rng, [], 8192), _pack(rng, [], 512)),
            (_pack(rng, pool[9000:9600], 8192),
             _pack(rng, pool[9500:9700], 512)),
            (_pack(rng, pool[:8192], 8192), _pack(rng, pool[:512], 512))]
    for cap_out in (8192, 16384):
        pa, pb = stack([a for a, _ in rows]), stack([b for _, b in rows])
        par.hold("overlay_merge_stacked",
                 (overlay_merge_stacked(pa, pb, cap_out),),
                 (merge_overlay_stacked_torch(pa, pb, cap_out),))
    log("k2 stacked parity S=8 (empty rows, all-overlap, tombstones, cap "
        "growth), cap_out 8192 and 16384: exact")
    ca, cb = 1 << 21, 64
    big = [(_pack(rng, pool[i * 300_000:i * 300_000 + 3520], ca),
            _pack(rng, pool[i * 300_000 + 3500:i * 300_000 + 3564], cb))
           for i in range(SHARDS)]
    pa, pb = stack([a for a, _ in big]), stack([b for _, b in big])
    par.hold("overlay_merge_stacked", (overlay_merge_stacked(pa, pb, ca),),
             (merge_overlay_stacked_torch(pa, pb, ca),))
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    km = time_cuda(lambda: overlay_merge_stacked(pa, pb, ca), 20, flush)
    pm = time_cuda(lambda: merge_overlay_stacked_torch(pa, pb, ca), 5, flush,
                   PLAIN_HOLD_CYCLES)
    live = int((pa[:, 0] != BIASED_MAX).sum())
    nb = int((pb[:, 0] != BIASED_MAX).sum())
    nbytes = 24 * (live + nb) + 24 * SHARDS * ca
    out = {"card": card, "rows": SHARDS, "Ca": ca, "Cb": cb, "cap_out": ca,
           "live": live, "batch_live": nb,
           "ms": float(np.median(km)), "mean_ms": float(km.mean()),
           "plain_ms": float(np.median(pm)),
           "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
           "library_ms": None}
    log(f"k2 stacked parity S={SHARDS} Ca=cap_out={ca} Cb={cb}: exact; "
        "timed: " + json.dumps(out))
    return out


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


def serve_and_check(eng, oracle: Oracle, trace: list) -> list:
    """Run every step of ``trace`` through ``eng`` and check each result
    against the oracle (the checks sit outside the engine's step timer).
    Returns every (op, key, result)."""
    out = []
    for si, step in enumerate(trace):
        reqs = [eng.submit(*r) for r in step]
        eng.step()
        out += [(r.op, r.key, r.result) for r in reqs]
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
    return out


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


def breakdown(eng, oracle, make, steps: int) -> dict:
    """Serve ``steps`` more steps of ``make(rng)`` through ``eng`` with the
    engine's phases timed on the host clock (device phases end in a
    synchronize): mean seconds per step in host writes, the overlay merge
    (batch upload + K2), gets (upload, K1, D2H, results) and scans; the rest
    is admission and bookkeeping."""
    import torch
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
        serve_and_check(eng, oracle, [make(rng) for _ in range(steps)])
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


PHASES = {"_after_writes": "overlay_merge", "_serve_gets": "gets",
          "_serve_scans": "scans"}


def index_profile(eng, oracle, make, steps: int, label: str) -> dict:
    """Device time over ``steps`` more steps of ``make(rng)`` through
    ``eng`` (``torch.profiler``; results still checked, outside the step
    timer): kernels a step, their device ms a step and the device's busy
    share of the engine's step time, each phase's host ms, its kernels'
    device ms and its span on the card (``record_function`` ranges), and
    the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(name, fn):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run

    def dev_us(e, own=True):
        if own:
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))
    rng = np.random.default_rng(31)
    trace = [make(rng) for _ in range(steps)]
    for attr, name in PHASES.items():
        setattr(eng, attr, ranged(name, getattr(eng, attr)))
    n0 = len(eng.step_seconds)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            serve_and_check(eng, oracle, trace)
            torch.cuda.synchronize()
    finally:
        for attr in PHASES:
            delattr(eng, attr)
    step_ms = float(np.sum(eng.step_seconds[n0:])) * 1e3 / steps
    ev = prof.key_averages()
    # a range appears twice: on the host (its time; its kernels' device
    # time) and on the card (first kernel to last, idle gaps included)
    kern = [e for e in ev if e.device_type == DeviceType.CUDA
            and e.key not in PHASES.values() and dev_us(e) > 0]
    total = sum(dev_us(e) for e in kern) / 1e3 / steps
    phases = {name: {} for name in PHASES.values()}
    for e in ev:
        if e.key not in phases:
            continue
        if e.device_type == DeviceType.CPU:
            phases[e.key]["host_ms"] = e.cpu_time_total / 1e3 / steps
            phases[e.key]["kernel_ms"] = dev_us(e, own=False) / 1e3 / steps
        else:
            phases[e.key]["device_span_ms"] = dev_us(e) / 1e3 / steps
    out = {"steps": steps, "step_ms": step_ms,
           "device_ms_per_step": total,
           "device_busy_share": total / step_ms,
           "kernels_per_step": sum(e.count for e in kern) / steps,
           "phases": phases,
           "top_kernels": [{"name": e.key[:80], "calls": e.count // steps,
                            "ms_per_step": dev_us(e) / 1e3 / steps}
                           for e in sorted(kern, key=dev_us,
                                           reverse=True)[:8]]}
    log(f"{label} profile (per step): " + json.dumps(out))
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


def _writes(rng, keys, hot: tuple, writes: int, upd_keys=None) -> list:
    """60% inserts of fresh keys in ``hot`` [lo, hi), 30% updates and 10%
    deletes of ``upd_keys`` (default: all keys)."""
    n_ins, n_upd = int(writes * 0.6), int(writes * 0.3)
    pick = keys if upd_keys is None else upd_keys
    reqs = [("insert", int(k), int(k) % 1_000_003 + 7)
            for k in rng.integers(hot[0], hot[1], n_ins, dtype=np.uint64)]
    reqs += [("insert", int(k), int(k) * 3 % 2**61)
             for k in rng.choice(pick, n_upd)]
    return reqs + [("delete", int(k))
                   for k in rng.choice(pick, writes - n_ins - n_upd)]


def make_sharded_step(rng, keys, bounds, hot: tuple, gets: int, writes: int,
                      scans: int) -> list:
    """The skewed sharded trace of ``benchmarks/sharded_serving.py``
    scaled up: fresh-key inserts in the hot shard's range, updates and
    deletes over every shard, gets uniform over the key range (10%
    absent), and scans of 100 of which half start among the last 50 keys
    up to a bound (they cross into the next shard)."""
    lo, hi = int(keys[0]), int(keys[-1]) + 1
    n_abs = gets // 10
    reqs = _writes(rng, keys, hot, writes)
    reqs += [("get", int(k)) for k in rng.choice(keys, gets - n_abs)]
    reqs += [("get", int(k)) for k in rng.integers(lo, hi, n_abs,
                                                   dtype=np.uint64)]
    ends = np.searchsorted(keys, rng.choice(bounds, scans // 2),
                           side="right")
    starts = keys[np.maximum(ends - rng.integers(1, 51, scans // 2), 0)]
    starts = np.concatenate([starts, rng.choice(keys, scans - scans // 2)])
    return reqs + [("scan", int(k), 0, 100) for k in starts]


def _shard_range(part, s: int) -> tuple:
    """[lo, hi) of shard ``s``'s keys."""
    b = part.bounds
    return (0 if s == 0 else int(b[s - 1]) + 1,
            2**64 - 1 if s == len(b) else int(b[s]) + 1)


def sharded_phase(keys, dev, card: str, par: Parity) -> dict:
    """The sharded path at the main path's size: ``partition_bulkload`` of
    its keys into SHARDS shards (default 4 KB geometry), a
    ``ShardedIndexEngine`` (gamma 0.05) serving SHARDED_STEPS skewed steps
    with every result checked against the oracle and the launch counts of
    K1's shard route, K2 and K2's stacked form read around exactly that
    run; then the step's breakdown and profile, and K1's shard route held
    and timed on the run's own tensors."""
    import torch
    from repro_torch.core import partition_bulkload
    from repro_torch.core.keys import keys_to_tensor
    from repro_torch.core.workloads import payloads_for
    from repro_torch.kernels.fused_lookup.ops import (fused_lookup_sharded,
                                                      lookup_sharded_plain)
    from repro_torch.kernels.overlay_merge.ops import (overlay_merge,
                                                       overlay_merge_stacked)
    from repro_torch.kernels.fused_lookup.ops import k1_bytes, k1_walks
    from repro_torch.serving import ShardedIndexEngine, pad_queries

    n = keys.shape[0]
    log(f"sharded path: {n} keys in {SHARDS} shards, {SHARDED_STEPS} steps")
    t0 = time.perf_counter()
    part = partition_bulkload(keys, payloads_for(keys), SHARDS)
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    eng = ShardedIndexEngine(part, device=dev)        # gamma = 0.05
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    stk = eng.stk
    log(f"sharded set-up: bulkloaded into {part.num_shards} shards in "
        f"{t1 - t0:.3f} s (sizes {[sh.n_items for sh in part.shards]}), "
        f"mirrored, stacked and moved to {eng.device} in {t2 - t1:.3f} s "
        f"(leaf pool {tuple(stk['leaf_keys'].shape)}, slot pool "
        f"{tuple(stk['slot_tag'].shape)}, inner height "
        f"{eng.sdi.max_inner_height}, overlay pack "
        f"{tuple(eng.ov_arrs['ov_pack'].shape)})")
    hot = _shard_range(part, SHARDS // 2)
    bounds = part.bounds.copy()

    def make(rng):
        return make_sharded_step(rng, keys, bounds, hot, 8192, 512, 16)
    rng = np.random.default_rng(23)
    trace = [make(rng) for _ in range(SHARDED_STEPS)]
    oracle = Oracle(keys)
    fused_lookup_sharded.launches = 0
    overlay_merge.launches = 0
    overlay_merge_stacked.launches = 0
    serve_and_check(eng, oracle, trace)
    launches = {"fused_lookup_sharded": fused_lookup_sharded.launches,
                "overlay_merge": overlay_merge.launches,
                "overlay_merge_stacked": overlay_merge_stacked.launches}
    st = eng.stats()
    step_s = np.asarray(eng.step_seconds)
    gets = np.array([r[1] for step in trace for r in step if r[0] == "get"],
                    dtype=np.uint64)
    per_shard = np.bincount(part.shard_of_batch(gets), minlength=SHARDS)
    out = {
        "card": card, "keys": n, "shards": part.num_shards,
        "steps": st["steps"], "requests": sum(len(s) for s in trace),
        "steps_per_s": st["steps"] / eng.serve_seconds,
        "p50_step_ms": float(np.percentile(step_s, 50)) * 1e3,
        "p99_step_ms": float(np.percentile(step_s, 99)) * 1e3,
        "first_step_ms": float(step_s[0]) * 1e3,
        "max_memory_allocated_bytes": int(torch.cuda.max_memory_allocated()),
        "setup_s": {"bulkload": t1 - t0, "mirror_stack_upload": t2 - t1},
        "gets_per_shard": per_shard.tolist(),
        "compactions": st["compactions"],
        "overlay_merges": st["overlay_merges"],
        "overlay_reseeds": st["overlay_reseeds"],
        "failed_swaps": st["failed_swaps"],
        "repart_failures": st["repart_failures"],
        "read_backend": st["read_backend"], "launches": launches,
        "checked": "every get, write and scan result equals the oracle",
    }
    log("sharded path: " + json.dumps(out))
    for k in ("fused_lookup_sharded", "overlay_merge"):
        if launches[k] == 0:
            raise AssertionError(f"{k} was not launched on the sharded path")
    # one card keeps one flat overlay pack: the stacked merge is the mesh's
    if launches["overlay_merge_stacked"]:
        raise AssertionError("overlay_merge_stacked ran on the one-card path")
    _no_failed_builds(st, "sharded path")
    if (per_shard == 0).any():
        raise AssertionError(f"a shard got no gets: {per_shard.tolist()}")
    out["breakdown_s"] = breakdown(eng, oracle, make, 5)
    out["profile"] = index_profile(eng, oracle, make, 3, "sharded path")
    _no_failed_builds(eng.stats(), "sharded path")

    # K1's shard route on the run's own tensors: the last step's gets
    stk, ovr, h = eng.stk, eng.ov_arrs, eng._height()
    q = keys_to_tensor(pad_queries([r[1] for r in trace[-1]
                                    if r[0] == "get"]), dev)
    Q = q.shape[0]
    got = fused_lookup_sharded(stk, ovr, q, h)
    par.hold("fused_lookup_sharded", got, lookup_sharded_plain(stk, ovr, q, h))
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    km = time_cuda(lambda: fused_lookup_sharded(stk, ovr, q, h), 50, flush)
    pm = time_cuda(lambda: lookup_sharded_plain(stk, ovr, q, h), 10, flush,
                   PLAIN_HOLD_CYCLES)
    rows = int(torch.unique(got[2]).numel())
    walks = k1_walks(stk, q)
    nbytes = k1_bytes(Q, walks, rows, stk["leaf_keys"].shape[2], True, True,
                      stk["bounds"].numel())
    out["k1"] = {"Q": Q, "height": h, "leaf_rows": rows, "walks": walks,
                 "ms": float(np.median(km)), "mean_ms": float(km.mean()),
                 "plain_ms": float(np.median(pm)),
                 "bound_ms": bound_ms(nbytes),
                 "bound_by": "bytes", "library_ms": None,
                 "launches": launches["fused_lookup_sharded"]}
    log(f"k1 sharded parity sharded path ({n}-key stack, Q={Q}, overlay "
        f"{tuple(ovr['ov_pack'].shape)}): exact; timed on {card}: "
        + json.dumps(out["k1"]))
    return out


def _no_failed_builds(st: dict, what: str) -> None:
    """The engine rolls a background build that raised back and serves
    on; on the card every build must land."""
    if st["failed_swaps"] or st["repart_failures"]:
        raise AssertionError(f"{what}: {st['failed_swaps']} compaction and "
                             f"{st['repart_failures']} split/merge builds "
                             "failed")


def _hot_step(rng, keys, hot: tuple, hot_keys) -> list:
    """512 writes inside the hot shard, 1024 gets over every shard (10%
    absent), 8 scans of 100."""
    lo, hi = int(keys[0]), int(keys[-1]) + 1
    return (_writes(rng, keys, hot, 512, hot_keys)
            + [("get", int(k)) for k in rng.choice(keys, 922)]
            + [("get", int(k)) for k in rng.integers(lo, hi, 102,
                                                     dtype=np.uint64)]
            + [("scan", int(k), 0, 100) for k in rng.choice(keys, 8)])


def sharded_maintenance(dev) -> None:
    """The sharded engine's maintenance on the card at MAINT_KEYS keys in
    SHARDS shards, every result checked against the oracle, synchronous
    and background runs answering request for request alike:
    shard-local compaction (gamma 0.001, writes in one hot shard: only it
    compacts, every cold shard keeps its mirror's journal epoch, full
    builds and refreshes), then online repartitioning (drift inserts above
    the loaded range until the load monitor splits, then a merge forced
    by hand)."""
    from repro_torch.core import partition_bulkload
    from repro_torch.core.workloads import make_dataset, payloads_for
    from repro_torch.serving import ShardedIndexEngine
    keys = make_dataset("covid", MAINT_KEYS, seed=3)
    results = {}
    for mode in ("sync", "async"):
        part = partition_bulkload(keys, payloads_for(keys), SHARDS)
        eng = ShardedIndexEngine(part, device=dev, gamma=0.001,
                                 async_compact=mode == "async")
        hs = SHARDS // 2
        hot = _shard_range(part, hs)
        hot_keys = keys[(keys >= np.uint64(hot[0]))
                        & (keys < np.uint64(hot[1]))]
        before = [(sh.di.journal_epoch, sh.di.full_builds, sh.di.refreshes)
                  for sh in eng.shards]
        rng = np.random.default_rng(19)
        oracle = Oracle(keys)
        out = []
        for i in range(8):
            out += serve_and_check(eng, oracle,
                                   [_hot_step(rng, keys, hot, hot_keys)])
            if i % 2:       # let every second step's builds land
                eng.drain_compactions()
        eng.drain_compactions()
        out += serve_and_check(eng, oracle, [[
            ("get", int(k)) for k in rng.choice(keys, 1024)]])
        st = eng.stats()
        cold = [s for s in range(SHARDS) if s != hs]
        moved = [s for s in cold if eng.shards[s].compactions
                 or (eng.shards[s].di.journal_epoch,
                     eng.shards[s].di.full_builds,
                     eng.shards[s].di.refreshes) != before[s]]
        log(f"sharded compaction {mode}: per shard "
            f"{st['compactions_per_shard']}, swaps={st['swaps']}, "
            f"restacks={st['full_restacks']}, overlay merges/reseeds="
            f"{st['overlay_merges']}/{st['overlay_reseeds']}; cold shards "
            f"kept their epoch: {not moved}; every result checked")
        if st["compactions_per_shard"][hs] < 2 or moved \
                or (mode == "async" and st["swaps"] < 2):
            raise AssertionError(f"sharded compaction {mode}: not local "
                                 f"(moved cold shards {moved})")
        _no_failed_builds(st, f"sharded compaction {mode}")
        results[("compact", mode)] = out

        # online repartitioning under drift above the loaded range
        part = partition_bulkload(keys, payloads_for(keys), SHARDS)
        eng = ShardedIndexEngine(part, device=dev, gamma=0.2,
                                 repartition=True, split_ratio=1.5,
                                 async_compact=mode == "async")
        rng = np.random.default_rng(29)
        oracle = Oracle(keys)
        top = int(keys[-1]) + 1
        out, drift = [], np.empty(0, np.uint64)
        for i in range(12):
            fresh = rng.integers(top, top + 2**40, 8192, dtype=np.uint64)
            drift = np.concatenate([drift, fresh])
            step = ([("insert", int(k), int(k) % 65_521) for k in fresh]
                    + [("get", int(k)) for k in rng.choice(drift, 256)]
                    + [("get", int(k)) for k in rng.choice(keys, 256)]
                    + [("scan", int(k), 0, 100)
                       for k in rng.choice(drift, 4)]
                    + [("scan", int(keys[-60]), 0, 100)])
            out += serve_and_check(eng, oracle, [step])
            eng.drain_compactions()
        splits = eng.splits
        if not eng.request_merge(0):
            raise AssertionError(f"repartition {mode}: merge refused")
        eng.drain_compactions()
        out += serve_and_check(eng, oracle, [
            [("get", int(k)) for k in rng.choice(keys, 512)]
            + [("get", int(k)) for k in rng.choice(drift, 512)]
            + [("scan", int(k), 0, 100) for k in rng.choice(keys, 8)]])
        st = eng.stats()
        log(f"sharded repartition {mode}: splits={splits} then merges="
            f"{st['merges']}, shards {st['num_shards']} (sizes "
            f"{st['shard_sizes']}), boundary version "
            f"{st['boundary_version']}, compactions={st['compactions']}, "
            f"restacks={st['full_restacks']}: every result checked")
        if splits < 1 or st["merges"] < 1:
            raise AssertionError(f"repartition {mode}: no split or merge")
        _no_failed_builds(st, f"sharded repartition {mode}")
        results[("repart", mode)] = out
    for phase in ("compact", "repart"):
        if results[(phase, "sync")] != results[(phase, "async")]:
            raise AssertionError(f"sharded {phase}: sync != async")
    log("sharded maintenance: sync == async, request for request")


# ------------------------------------------------------------------- phase 5
HOLD_CYCLES = 2_000_000     # about 1 ms of spinning at the H100's clocks
# a plain version enqueues hundreds of small launches, up to about 20 ms of
# the host's time: its hold must outlast that, or its time is the host's
PLAIN_HOLD_CYCLES = 60_000_000


def time_cuda(fn, reps: int, flush, hold: int = HOLD_CYCLES) -> np.ndarray:
    """ms of each of ``reps`` launches of ``fn``, each timed by CUDA events
    after a write of ``flush`` evicted L2.  The stream then spins on the
    card for ``hold`` cycles (``torch.cuda._sleep``), so the host has
    enqueued ``fn``'s launches before the start event fires and the events
    time the device's work alone, not the host's enqueue."""
    import torch
    fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(hold)
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
    from repro_torch.kernels.fused_lookup.ops import (
        _as_stack, _launch_plan, fused_lookup, k1_bytes, k1_walks,
        lookup_plain)
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
    def k1():
        return fused_lookup(arrs, ovr, q, h)
    k1_ms = time_cuda(k1, 50, flush)
    k1_plain = time_cuda(lambda: lookup_plain(arrs, ovr, q, h), 10, flush,
                         PLAIN_HOLD_CYCLES)
    leaf = got[2]
    C = arrs["leaf_keys"].shape[1]
    rows = int(torch.unique(leaf).numel())
    walks = k1_walks(arrs, q)
    plan = _launch_plan(_as_stack(arrs))
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
    merged = overlay_merge(pack, batch, cap_out)
    par.hold("overlay_merge", (merged,),
             (merge_overlay_pack_torch(pack, batch, cap_out),))
    out_live = int((merged[0] != BIASED_MAX).sum())
    del merged
    log(f"k2 parity main path (served pack, live {live}, Cb="
        f"{batch.shape[1]}): exact")
    def k2():
        return overlay_merge(pack, batch, cap_out)
    k2_ms = time_cuda(k2, 20, flush)
    k2_plain = time_cuda(lambda: merge_overlay_pack_torch(pack, batch,
                                                          cap_out), 5, flush,
                         PLAIN_HOLD_CYCLES)
    nb = int((batch[0] != BIASED_MAX).sum())
    k2_bytes = 24 * (live + nb) + 24 * cap_out
    # K2's live-entry bound: the live entries in and the merged ones out,
    # as if the output's padding were already in place (a log line, for
    # PERF.md; the bound_ms of the kernels line is the full rewrite)
    log(f"k2 live-entry bound: {live} + {nb} in, {out_live} out: "
        f"{bound_ms(24 * (live + nb) + 24 * out_live)} ms against the full "
        f"rewrite's {bound_ms(k2_bytes)} ms")
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
         "bound_ms": bound_ms(k1_bytes(Q, walks, rows, C, True)),
         "bound_by": "bytes", "library_ms": None, "parity": "exact",
         "cases": par.cases["fused_lookup"], "walks": walks,
         "plan": plan._asdict()},
        {"name": "overlay_merge", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES,
         "launches": mp["launches"]["overlay_merge"],
         "max_abs_err": par.err["overlay_merge"],
         "ms": float(np.median(k2_ms)), "mean_ms": float(k2_ms.mean()),
         "plain_ms": float(np.median(k2_plain)),
         "bound_ms": bound_ms(k2_bytes),
         "bound_by": "bytes", "library_ms": None, "parity": "exact",
         "cases": par.cases["overlay_merge"]},
    ]


def staged_phase(mp: dict, par: Parity, dev, card: str) -> list:
    """The staged block-at-a-time read (``examples/quickstart.py`` §3) on
    the main path's 200M-key mirror and served overlay pack, over the last
    step's get batch: launch counts around exactly that run, its answers
    against K1 and the host oracle, K3/K4/K5 against their plain versions
    on those tensors, their times and bounds, and the staged batch's host
    time beside K1's for the same reads."""
    import torch
    from repro_torch.core.keys import keys_to_tensor
    from repro_torch.kernels import ProbeIndex, inner_probe_lookup
    from repro_torch.kernels.fused_lookup.ops import fused_lookup
    from repro_torch.kernels.inner_probe import ops as k5
    from repro_torch.kernels.leaf_search import ops as k4
    from repro_torch.kernels.overlay_probe import ops as k3
    from repro_torch.serving import pad_queries

    eng = mp["engine"]
    arrs, ovr, h = eng.arrs, eng.ov_arrs, eng._height()
    gets = [r[1] for r in mp["trace"][-1] if r[0] == "get"]
    q = keys_to_tensor(pad_queries(gets), dev)
    Q, n = q.shape[0], len(gets)
    pi = ProbeIndex(arrs, eng.di.inner_height)
    wrappers = {"overlay_probe": k3.overlay_probe,
                "leaf_search": k4.leaf_search, "inner_probe": k5.probe_level}
    for w in wrappers.values():
        w.launches = 0
    trace = []
    pay, found = _staged_read(pi, ovr, q, trace)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"staged read (200M-key mirror, Q={Q}, overlay "
        f"{tuple(ovr['ov_pack'].shape)}): launches {json.dumps(launches)}")
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"{k} was not launched on the staged path")

    # answers: the snapshot read == K1's, the merged read == the oracle's
    snap_pay, snap_found, rounds = inner_probe_lookup(pi, q, count_rounds=True)
    k1_pay, k1_found, _ = fused_lookup(arrs, None, q, h)
    if not (torch.equal(snap_found, k1_found) and torch.equal(
            torch.where(snap_found, snap_pay, 0), k1_pay)):
        raise AssertionError("staged snapshot read != K1 on the main path")
    oracle = mp["oracle"]
    n_found = _check_oracle(oracle, np.array(gets, dtype=np.uint64),
                            pay[:n], found[:n])
    # and where the overlay decides: a batch of keys written since the
    # snapshot (inserts, updates, deletes)
    wk = np.array(sorted(oracle.writes), dtype=np.uint64)
    wq = np.random.default_rng(17).choice(wk, min(Q, wk.size), replace=False)
    w_pay, w_found = _staged_read(pi, ovr, keys_to_tensor(wq, dev))
    w_n = _check_oracle(oracle, wq, w_pay, w_found)
    log(f"staged read == K1 snapshot read and == the oracle on all {n} "
        f"gets ({n_found} found; {rounds} rounds incl. the leaf) and on "
        f"{wq.size} written keys ({w_n} found)")

    # each launch of that run == its plain version on the same tensors
    plain = {"probe_level": ("inner_probe", k5.probe_level_plain),
             "leaf_search": ("leaf_search", k4.leaf_search_plain),
             "overlay_probe": ("overlay_probe", k3.overlay_probe_plain)}
    for fn, args, out in trace:
        name, ref = plain[fn]
        par.hold(name, out, ref(*args))
    calls = [fn for fn, _, _ in trace]
    log(f"k3/k4/k5 parity main path: every launch of the staged read "
        f"({calls.count('probe_level')} K5 rounds, "
        f"{calls.count('leaf_search')} K4 calls on PA/BT and leaf rows, "
        f"K3 on the served pack) == its plain version on its own tensors: "
        "exact")

    # times at these shapes (median launch, L2 flushed before each): K5 on
    # the root round's slots, K4 on the final leaf rows, as launched above
    s0 = next(args[1] for fn, args, _ in trace if fn == "probe_level")
    leaf = [args[2] for fn, args, _ in trace if fn == "leaf_search"][-1]
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    keys, pays = arrs["leaf_keys"], arrs["leaf_pay"]
    pack = ovr["ov_pack"]
    # K4's library call: the rank alone, over the rows gathered beforehand
    blk = keys[leaf.long()]
    qc = q[:, None].contiguous()
    t = {
        "inner_probe": (lambda: k5.probe_level(arrs, s0, q),
                        lambda: k5.probe_level_plain(arrs, s0, q), None),
        "leaf_search": (lambda: k4.leaf_search(keys, pays, leaf, q),
                        lambda: k4.leaf_search_plain(keys, pays, leaf, q),
                        lambda: torch.searchsorted(blk, qc)),
        "overlay_probe": (lambda: k3.overlay_probe(ovr, q),
                          lambda: k3.overlay_probe_plain(ovr, q),
                          lambda: torch.searchsorted(pack[0], q)),
    }
    ms = {k: (time_cuda(f, 50, flush),
              time_cuda(p, 10, flush, PLAIN_HOLD_CYCLES),
              time_cuda(lib, 50, flush) if lib else None)
          for k, (f, p, lib) in t.items()}
    del blk, qc
    hits = int(k3.overlay_probe(ovr, q)[1].sum())
    rows = int(torch.unique(leaf).numel())
    C = keys.shape[1]
    # bytes each must move (inputs read once, outputs written once, only
    # what this batch touches): K4 the fewest sectors a search of these
    # rows reads at any lanes a query (k4_least_sectors), then per query
    # its row id and key, the payload at the rank, payload + found out
    # (beside it the whole-row count: each distinct leaf row read whole);
    # K5 and K3 as their ops' k5_bytes / k3_bytes count them on this data
    walk = k5.probe_walk(arrs, s0, q)
    lanes = k4.k4_lanes(C, Q, torch.cuda.get_device_properties(dev)
                        .multi_processor_count)
    rank, _, sectors = k4.k4_walk(keys, leaf, q, lanes)
    least, least_lanes = k4.k4_least_sectors(keys, leaf, q)
    bytes_ = {"leaf_search": k4.k4_bytes(Q, least, int((rank < C).sum())),
              "inner_probe": k5.k5_bytes(*walk),
              "overlay_probe": k3.k3_bytes(Q, hits)}
    k4_extra = {"lanes": lanes,
                "whole_row_bound_ms": bound_ms(k4.k4_row_bytes(Q, rows, C))}
    log(f"staged K4 at Q={Q}, C={C} over {rows} leaf rows: {lanes} lanes a "
        f"query (k4_lanes) read {sectors.numel()} sectors; the fewest, "
        f"{least}, at {least_lanes} lanes, make the search bound")
    log(f"staged K5 walks at Q={Q}: stale hops "
        f"{torch.bincount(walk[1], minlength=4).tolist()}, slot records "
        f"{torch.bincount(walk[0], minlength=5).tolist()}")

    # the whole staged batch on the host clock, beside K1's read of it
    def host_ms(fn, reps=10):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return np.array(out)
    staged = host_ms(lambda: _staged_read(pi, ovr, q))
    k1 = host_ms(lambda: fused_lookup(arrs, ovr, q, h))
    summary = {"card": card, "Q": Q, "rounds": rounds,
               "staged_ms_p50": float(np.median(staged)),
               "staged_ms_min": float(staged.min()),
               "k1_ms_p50": float(np.median(k1)),
               "k1_ms_min": float(k1.min()),
               "ratio_p50": float(np.median(staged) / np.median(k1)),
               "leaf_rows": rows, "overlay_hits": hits}
    mp["summary"]["staged"] = summary
    log("staged batch vs K1 (host clock, ms): " + json.dumps(summary))
    out = []
    for k, (src, replaces) in STAGED.items():
        km, pm, lm = ms[k]
        out.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[k], "max_abs_err": par.err[k],
            "ms": float(np.median(km)), "mean_ms": float(km.mean()),
            "plain_ms": float(np.median(pm)),
            "bound_ms": bound_ms(bytes_[k]),
            "bound_by": "bytes",
            "library_ms": float(np.median(lm)) if lm is not None else None,
            "parity": "exact", "cases": par.cases[k],
            **(k4_extra if k == "leaf_search" else {})})
    return out


# ------------------------------------------------------------- phases 7 and 8
def _lm_cfg():
    from repro_torch.configs import get_config
    return get_config(LM_ARCH)


def lm_parity(dev) -> None:
    """The LM engine on the card == the same engine on the CPU (the plain
    versions of K1 and K6), on a tiny config: equal tokens and positions,
    logits within 1e-4, page pools within 1e-5."""
    import copy
    import dataclasses
    import torch
    from repro_torch.models import init_params
    from repro_torch.serving import Request, ServeEngine
    cfg = dataclasses.replace(
        _lm_cfg().reduced(), n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
        head_dim=32, d_ff=128, vocab_size=128, compute_dtype="float32")
    cpu_model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    kw = dict(slots=2, page_size=8, n_pages=64, max_pages_per_seq=8)
    cpu = ServeEngine(cfg, cpu_model, device="cpu", **kw)
    card = ServeEngine(cfg, copy.deepcopy(cpu_model).to(dev), device=dev,
                       **kw)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 100, 4).tolist() for _ in range(7)]
    for eng in (cpu, card):
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=list(p), max_new=3))
    worst = 0.0
    while cpu.queue or any(r is not None for r in cpu.slots):
        a, b = cpu.step(), card.step()
        worst = max(worst, float((b.cpu() - a).abs().max()))
        if not torch.allclose(b.cpu(), a, atol=1e-4, rtol=1e-4) \
                or cpu.slot_pos.tolist() != card.slot_pos.tolist():
            raise AssertionError(f"LM engine on the card != on the CPU at "
                                 f"step {cpu.steps}")
    if [(r.rid, r.out) for r in cpu.completed] != \
            [(r.rid, r.out) for r in card.completed] or \
            len(card.completed) != len(prompts):
        raise AssertionError("LM engine on the card: tokens differ from the "
                             "CPU's")
    for k in ("k", "v"):
        if not torch.allclose(card.kv[k].cpu(), cpu.kv[k], atol=1e-5,
                              rtol=1e-5):
            raise AssertionError(f"LM engine on the card: {k} pool differs")
    log(f"lm parity (tiny config, {cpu.steps} steps, {len(prompts)} "
        f"requests): card == CPU, equal tokens, logits within {worst}")


def lm_phase(dev, card: str, par: Parity) -> dict:
    """qwen3-4b at full width serving LM_REQUESTS requests through the
    port's ``ServeEngine``, with the K1/K6 launch counts read around exactly
    that run; every K6 launch of its first LM_HELD_STEPS steps held, every
    translation held to the host index, the step's split timed on the host
    clock (its device work ends in a synchronize), the reference's
    empty-slot defect counted.  The checks sit outside the step times."""
    import torch
    from repro_torch.kernels.fused_lookup.ops import fused_lookup
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention, paged_attention_plain)
    from repro_torch.models import init_params
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving import paged_model

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the LM path must run full float32")
    cfg = _lm_cfg()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = ServeEngine(cfg, model, device=dev, **LM_ENGINE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"lm set-up: {LM_ARCH} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} kv heads "
        f"of {cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), "
        f"{n_params} float32 parameters, page pool "
        f"{2 * eng.kv['k'].numel() * 4} bytes, in "
        f"{time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(LM_REQUESTS):
        n = int(rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1))
        reqs.append(Request(rid=i, prompt=rng.integers(
            1, cfg.vocab_size, n).tolist(), max_new=LM_MAX_NEW))
        eng.submit(reqs[-1])

    acc = dict.fromkeys(("host", "mirror", "translate", "decode", "head",
                         "check"), 0.0)
    defect = {"empty_slot_steps": 0, "empty_slot_writes": 0,
              "writes_on_live_pages": 0}
    table, page = eng.table, eng.page_size

    def timed(name, fn, sync=False):
        def run(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            acc[name] += time.perf_counter() - t
            return out
        return run

    translate = table.translate_batch
    held = {"translations": 0, "keys": 0}
    k1_case = {}

    def checked_translate(seqs, lps):
        m0 = acc["mirror"]
        t = time.perf_counter()
        out = translate(seqs, lps)
        torch.cuda.synchronize()
        acc["translate"] += time.perf_counter() - t - (acc["mirror"] - m0)
        t = time.perf_counter()
        got = out.cpu().numpy()
        keys = (seqs.astype(np.uint64) << np.uint64(20)) \
            | lps.astype(np.uint64)
        if eng.steps == LM_K1_STEP:   # K1's own inputs, timed after the run
            k1_case.update(arrs=table._arrs, keys=keys, h=max(
                table._mirror.max_inner_height, 3))
        exp = [table.index.lookup(int(k)) for k in keys]
        exp = np.array([-1 if e is None else e for e in exp], np.int64)
        if not np.array_equal(got, exp):
            raise AssertionError(f"translate_batch (K1) != the host index "
                                 f"at {int((got != exp).sum())} keys")
        held["translations"] += 1
        held["keys"] += keys.size
        # the reference's defect: an empty slot decodes into the page its
        # row translates to (-1 -> page 0); count its k/v writes (one pair
        # a layer) and those that land on a page a live sequence owns
        tables = np.maximum(got, 0).reshape(len(eng.slots), -1)
        owned = {p for pages in table._pages_of.values() for _, p in pages}
        empty = [s for s, r in enumerate(eng.slots) if r is None]
        defect["empty_slot_steps"] += bool(empty)
        for s in empty:
            lp = max(int(eng.slot_pos[s]) + 1, 0) // page
            defect["empty_slot_writes"] += cfg.n_layers
            if lp < tables.shape[1] and int(tables[s, lp]) in owned:
                defect["writes_on_live_pages"] += cfg.n_layers
        acc["check"] += time.perf_counter() - t
        return out

    orig = (paged_model._head, engine_mod.paged_decode_step)
    eng._admit = timed("host", eng._admit)
    eng._ensure_pages = timed("host", eng._ensure_pages)
    table.mirror = timed("mirror", table.mirror)
    table.translate_batch = checked_translate
    paged_model._head = timed("head", orig[0], sync=True)
    engine_mod.paged_decode_step = timed("decode", orig[1], sync=True)
    fused_lookup.launches = 0
    paged_attention.launches = 0
    step_s = []
    try:
        while eng.queue or any(r is not None for r in eng.slots):
            trace = [] if eng.steps < LM_HELD_STEPS else None
            c0 = acc["check"]
            t = time.perf_counter()
            logits = eng.step(trace=trace)
            step_s.append(time.perf_counter() - t - (acc["check"] - c0))
            if trace is not None:
                if len(trace) != cfg.n_layers:
                    raise AssertionError("K6 was not launched once a layer")
                for args, out in trace:
                    par.close("paged_attention", out,
                              paged_attention_plain(*args))
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"non-finite logits at step {eng.steps}")
    finally:
        paged_model._head, engine_mod.paged_decode_step = orig
        for name in ("_admit", "_ensure_pages"):
            delattr(eng, name)
        for name in ("mirror", "translate_batch"):
            delattr(table, name)
    launches = {"fused_lookup": fused_lookup.launches,
                "paged_attention": paged_attention.launches}
    peak = int(torch.cuda.max_memory_allocated())

    # every request done with LM_MAX_NEW tokens, every page reclaimed, each
    # kernel of the path launched (K1 once a step, K6 once a layer a step)
    steps = eng.steps
    if len(eng.completed) != LM_REQUESTS or any(
            len(r.out) != LM_MAX_NEW for r in reqs):
        raise AssertionError("lm: a request did not complete with "
                             f"{LM_MAX_NEW} tokens")
    if eng.pool_pages.n_free != LM_ENGINE["n_pages"]:
        raise AssertionError(f"lm: {LM_ENGINE['n_pages'] - eng.pool_pages.n_free}"
                             " pages not reclaimed")
    if launches["fused_lookup"] != steps \
            or launches["paged_attention"] != steps * cfg.n_layers:
        raise AssertionError(f"lm: launches {launches} over {steps} steps")
    step_s = np.asarray(step_s)
    serve_s = float(step_s.sum())
    fed = sum(len(r.prompt) + len(r.out) - 1 for r in reqs)
    gen = sum(len(r.out) for r in reqs)
    split = {"host": acc["host"] + acc["mirror"],
             "translate": acc["translate"],
             "layers": acc["decode"] - acc["head"], "head": acc["head"]}
    split["other"] = serve_s - sum(split.values())
    out = {
        "card": card, "arch": LM_ARCH, "params": n_params,
        "requests": LM_REQUESTS, "steps": steps,
        "tokens_fed": fed, "tokens_generated": gen,
        "slot_use": fed / (steps * LM_ENGINE["slots"]),
        "tokens_per_s": fed / serve_s,
        "generated_tokens_per_s": gen / serve_s,
        "p50_step_ms": float(np.percentile(step_s, 50)) * 1e3,
        "p99_step_ms": float(np.percentile(step_s, 99)) * 1e3,
        "first_step_ms": float(step_s[0]) * 1e3,
        "step_split_ms": {k: v / steps * 1e3 for k, v in split.items()},
        "mirror_host_ms_per_step": acc["mirror"] / steps * 1e3,
        "max_memory_allocated_bytes": peak,
        "launches": launches, "k6_launches_held": LM_HELD_STEPS
        * cfg.n_layers, "translations_held": held,
        "reference_defect": defect,
        "checked": "K6 launches of the first steps == plain (f32 1e-5); "
                   "every translation == the host index; every request "
                   "complete; every page reclaimed; logits finite",
    }
    log("lm serving: " + json.dumps(out))
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"{k} was not launched on the LM path")
    out["k1"] = lm_k1_timing(k1_case, par, dev, card, launches["fused_lookup"])
    out["profile"] = lm_profile(eng, card)
    del eng, model
    return out


def lm_k1_timing(case: dict, par: Parity, dev, card: str,
                 launches: int) -> dict:
    """K1 on the LM path's own page-table mirror and translation batch of
    step LM_K1_STEP (slots x max_pages_per_seq keys, no overlay): held to
    its plain version, then timed like the index path's K1."""
    import torch
    from repro_torch.core.keys import keys_to_tensor
    from repro_torch.kernels.fused_lookup.ops import (fused_lookup, k1_bytes,
                                                      k1_walks, lookup_plain)
    if not case:
        raise AssertionError(f"lm: no translation at step {LM_K1_STEP}")
    arrs, h = case["arrs"], case["h"]
    q = keys_to_tensor(case["keys"], dev)
    Q = q.shape[0]
    got = fused_lookup(arrs, None, q, h)
    par.hold("fused_lookup", got, lookup_plain(arrs, None, q, h))
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    km = time_cuda(lambda: fused_lookup(arrs, None, q, h), 50, flush)
    pm = time_cuda(lambda: lookup_plain(arrs, None, q, h), 10, flush,
                   PLAIN_HOLD_CYCLES)
    rows = int(torch.unique(got[2]).numel())
    C = arrs["leaf_keys"].shape[1]
    walks = k1_walks(arrs, q)
    out = {"Q": Q, "step": LM_K1_STEP, "height": h, "leaf_rows": rows,
           "walks": walks,
           "leaf_pool": list(arrs["leaf_keys"].shape),
           "found": int(got[1].sum()),
           "ms": float(np.median(km)), "mean_ms": float(km.mean()),
           "plain_ms": float(np.median(pm)),
           "bound_ms": bound_ms(k1_bytes(Q, walks, rows, C, False)),
           "bound_by": "bytes", "library_ms": None, "launches": launches}
    log(f"k1 parity lm path (page-table mirror, Q={Q}, step {LM_K1_STEP}): "
        f"exact; timed on {card}: " + json.dumps(out))
    return out


def lm_profile(eng, card: str) -> dict:
    """Device time by kernel over LM_PROFILED_STEPS steady steps of the
    engine (``torch.profiler``, after the measured run): a fresh batch of
    LM_PROFILE_PROMPT-token requests fills every slot, LM_PROFILE_WARM
    steps feed their prompts, the next LM_PROFILED_STEPS are traced; then
    they run to completion and every page must be back.  The device's busy share is the traced kernels' time
    over the traced steps' wall time (which the profiler itself slows)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import Request
    rng = np.random.default_rng(3)
    for i in range(LM_ENGINE["slots"]):
        eng.submit(Request(rid=1000 + i, prompt=rng.integers(
            1, eng.cfg.vocab_size, LM_PROFILE_PROMPT).tolist(),
            max_new=LM_MAX_NEW))
    for _ in range(LM_PROFILE_WARM):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(LM_PROFILED_STEPS):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    eng.run(max_steps=eng.steps + 1000)
    if eng.pool_pages.n_free != LM_ENGINE["n_pages"] or eng.queue:
        raise AssertionError("lm profile: requests or pages left over")

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # the kernels themselves: an operator's row repeats its kernels' time
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    total = sum(dev_us(e) for e in rows)
    top = sorted(rows, key=dev_us, reverse=True)[:12]
    n = LM_PROFILED_STEPS
    # K6: its split and combine kernels (one C call a layer)
    k6 = [e for e in rows if "paged_attention" in e.key]
    out = {"card": card, "steps": n, "wall_ms_per_step": wall / n * 1e3,
           "device_ms_per_step": total / n / 1e3,
           "device_busy_share": total / 1e6 / wall,
           "kernels_per_step": sum(e.count for e in rows) / n,
           "k6_ms_per_step": sum(dev_us(e) for e in k6) / n / 1e3,
           "k6_kernels_per_step": sum(e.count for e in k6) / n,
           "top_kernels": [{"name": e.key[:90], "calls": e.count // n,
                            "ms_per_step": dev_us(e) / n / 1e3}
                           for e in top]}
    log("lm profile (device time by kernel, per step): " + json.dumps(out))
    return out


def _k6_shape(dev, par: Parity, B: int, NP: int, pool: int, lo: int,
              hi: int, seed: int, flush) -> dict:
    """K6 alone on ``B`` rows of ``lo``-``hi`` tokens, ``NP`` pages of 16 a
    row from a shuffled ``pool``-page pool of one qwen3-4b layer, float32
    and bfloat16: held to its plain version on these inputs and on a copy
    with a row of length 0 and one of every token, then timed beside its
    plain version and one ``scaled_dot_product_attention`` call over the
    same KV gathered contiguous (the gather is not timed)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.ops import (
        _split_plan, paged_attention, paged_attention_plain)
    cfg = _lm_cfg()
    H, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    page = LM_ENGINE["page_size"]
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.permutation(pool)[:B * NP].reshape(
        B, NP).astype(np.int32)).to(dev)
    lens_np = rng.integers(lo, hi + 1, B).astype(np.int32)
    lens = torch.from_numpy(lens_np).to(dev)
    edge = lens.clone()
    edge[0], edge[1] = 0, NP * page
    gen = torch.Generator(device=dev).manual_seed(seed)
    S = NP * page
    mask = (torch.arange(S, device=dev)[None, :] < lens[:, None]
            )[:, None, None, :]
    pps, n_splits = _split_plan(B, hk, NP, page)
    out = {"rows": B, "pages_a_row": NP, "pool_pages": pool,
           "lengths": [int(lens_np.min()), int(lens_np.max())],
           "tokens": int(lens_np.sum()), "pages_per_split": pps,
           "n_splits": n_splits}
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn((B, H, dh), generator=gen, device=dev).to(dt)
        kp = torch.randn((pool, page, hk, dh), generator=gen,
                         device=dev).to(dt)
        vp = torch.randn((pool, page, hk, dh), generator=gen,
                         device=dev).to(dt)
        for ln in (lens, edge):
            par.close("paged_attention", paged_attention(table, ln, q, kp, vp),
                      paged_attention_plain(table, ln, q, kp, vp))
        kc = kp[table.reshape(-1).long()].reshape(B, S, hk, dh).transpose(
            1, 2).contiguous()
        vc = vp[table.reshape(-1).long()].reshape(B, S, hk, dh).transpose(
            1, 2).contiguous()
        qs = q[:, :, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(qs, kc, vc, attn_mask=mask,
                                                  enable_gqa=True)
        lib_err = float((sdpa()[:, :, 0].float()
                         - paged_attention(table, lens, q, kp, vp).float()
                         ).abs().max())
        km = time_cuda(lambda: paged_attention(table, lens, q, kp, vp), 50,
                       flush)
        pm = time_cuda(lambda: paged_attention_plain(table, lens, q, kp, vp),
                       5, flush, PLAIN_HOLD_CYCLES)
        lm = time_cuda(sdpa, 50, flush)
        elt = q.element_size()
        # bytes K6 must move: the live tokens' K and V of the row's kv
        # heads, q in and out, the table and lengths
        nbytes = int(lens_np.sum()) * hk * dh * elt * 2 + 2 * q.numel() * elt \
            + table.numel() * 4 + B * 4
        name = str(dt).removeprefix("torch.")
        out[name] = {"ms": float(np.median(km)), "mean_ms": float(km.mean()),
                     "plain_ms": float(np.median(pm)),
                     "library_ms": float(np.median(lm)),
                     "bound_ms": bound_ms(nbytes),
                     "bytes": nbytes, "sdpa_max_abs_diff": lib_err}
        del q, kp, vp, kc, vc
    return out


def k6_timing(dev, card: str, par: Parity, launches: int) -> dict:
    """K6 alone at the served decode shape of the LM path (K6_SERVED_ROWS
    rows of 89-96 tokens over the engine's 32 pages a row and 512-page
    pool) and at a long-context one (K6_ROWS rows of 2048-4096 tokens,
    K6_NP pages a row, a K6_POOL-page pool): each held, then timed
    (``_k6_shape``).  The long-context float32 numbers head the entry."""
    import torch
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    served = _k6_shape(dev, par, K6_SERVED_ROWS, LM_ENGINE[
        "max_pages_per_seq"], LM_ENGINE["n_pages"], *K6_SERVED_LENS, 22,
        flush)
    log(f"k6 alone on {card}, served shape: " + json.dumps(served))
    out = _k6_shape(dev, par, K6_ROWS, K6_NP, K6_POOL, 2048, 4096, 21, flush)
    log(f"k6 alone on {card}, long context: " + json.dumps(out))
    f32 = out["float32"]
    return {"name": "paged_attention", "route": "cuda", "source": K6_SOURCE,
            "replaces": K6_REPLACES, "launches": launches,
            "max_abs_err": par.err["paged_attention"],
            "ms": f32["ms"], "mean_ms": f32["mean_ms"],
            "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": "bytes", "library_ms": f32["library_ms"],
            "parity": "float32 within 1e-5 (bfloat16 within 3e-2)",
            "max_abs_err_bf16": par.err_bf16["paged_attention"],
            "bf16": out["bfloat16"], "served": served,
            "cases": par.cases["paged_attention"]}


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
    ptxas = build_kernels()
    par = Parity()
    k1_parity(par, dev)
    k34_edge_parity(par, dev)
    k2_parity(par, dev)
    k1_sharded_parity(par, dev)
    k2s = k2_stacked_parity(par, dev, card)
    mp = main_path(MAIN_KEYS, MAIN_STEPS, dev, card)
    lo, hi = mp["span"]
    mp["summary"]["breakdown_s"] = breakdown(
        mp["engine"], mp["oracle"],
        lambda rng: make_step(rng, mp["keys"], lo, hi, 8192, 512, 16), 5)
    compaction_phase(dev)
    sharded_maintenance(dev)
    kernels = measure(mp, par, dev)
    kernels += staged_phase(mp, par, dev, card)
    s, keys = mp["summary"], mp["keys"]
    del mp                  # free the monolithic index and its tensors
    gc.collect()
    torch.cuda.empty_cache()
    sh = sharded_phase(keys, dev, card, par)
    del keys
    gc.collect()
    torch.cuda.empty_cache()
    kernels[0]["sharded"] = {
        "name": "fused_lookup_sharded", "route": "cuda",
        **sh["k1"], "source": K1_SOURCE, "replaces": K1S_REPLACES,
        "monolithic_ms": kernels[0]["ms"],
        "max_abs_err": par.err["fused_lookup_sharded"],
        "cases": par.cases["fused_lookup_sharded"], "parity": "exact"}
    kernels[1]["stacked"] = {
        "name": "overlay_merge_stacked", "route": "cuda",
        **k2s, "source": K2_SOURCE, "replaces": K2_REPLACES,
        "launches": sh["launches"]["overlay_merge_stacked"],
        "max_abs_err": par.err["overlay_merge_stacked"],
        "cases": par.cases["overlay_merge_stacked"], "parity": "exact"}
    lm_parity(dev)
    lm = lm_phase(dev, card, par)
    kernels[0]["lm"] = lm.pop("k1")
    torch.cuda.empty_cache()
    kernels.append(k6_timing(dev, card, par,
                             lm["launches"]["paged_attention"]))
    for k in kernels:
        k["ptxas"] = ptxas[k["name"]]
        log(f"{k['name']} on {card}: median launch {k['ms']} ms of device "
            f"time, stream held (mean "
            f"{k['mean_ms']} ms; plain median {k['plain_ms']} ms,"
            f" bound {k['bound_ms']} ms by {k['bound_by']}), "
            f"{k['launches']} launches on the main path")
    log(f"end to end on {card}: {s['steps_per_s']} steps/s, p99 step "
        f"{s['p99_step_ms']} ms, peak device memory "
        f"{s['max_memory_allocated_bytes']} bytes")
    log(f"sharded end to end on {card}: {sh['steps_per_s']} steps/s, p50 "
        f"step {sh['p50_step_ms']} ms, p99 step {sh['p99_step_ms']} ms, "
        f"peak device memory {sh['max_memory_allocated_bytes']} bytes; K1 "
        f"sharded {sh['k1']['ms']} ms (monolithic {kernels[0]['ms']} ms)")
    log(f"lm end to end on {card}: {lm['tokens_per_s']} tokens/s "
        f"({lm['generated_tokens_per_s']} generated), p50 step "
        f"{lm['p50_step_ms']} ms, p99 step {lm['p99_step_ms']} ms, peak "
        f"device memory {lm['max_memory_allocated_bytes']} bytes; total "
        f"{time.perf_counter() - t_start:.3f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
