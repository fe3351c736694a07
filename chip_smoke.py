#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the AULID serving engine on one CUDA card.

    python3 chip_smoke.py      # 200M keys, 50 steps (30 in 8 shards, 25 on
                               # the index mesh), not cut

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
   growth, Ca = 2^24 with Cb = 512), fresh and into poisoned targets
   (garbage below their fill, which lies below and past the merged count,
   padding after), fills held too; K1's shard route
   (``fused_lookup_sharded``) on stacks of the same datasets (200k keys in
   1, 3 and 8 shards and in 5 shards padded to 8 slots; the 20M-key osm
   mirror in 8 shards), queries at every bound +- 1, without and with an
   overlay; K2's stacked form (``overlay_merge_stacked``) on 8 rows of
   every kind, fresh and into a poisoned target with a fill a row, and on
   8 rows of Ca = cap_out = 2^21 with Cb = 64, timed in steady state (into
   a target holding padding past the rows' fills) and into a fresh one;
   on those rows its mesh form (``overlay_merge_stacked_mesh``, each
   position merging its own rows) over cuda:0 named 1, 2 and 4 times ==
   the one-launch stacked form == the plain merge, one launch a position,
   timed at 4 positions;
3. the main path: ``IndexEngine`` serving 200M covid-like keys (payload =
   key + 1, default 4 KB geometry — the paper's evaluation size) for 50
   steps of 8192 gets (10% absent), 512 writes (60% new-key inserts, 30%
   updates, 10% deletes) and 16 scans of 100, every result checked against
   a host oracle (the sorted keys plus a dict of the writes) and every
   step's merged overlay pack held, after the step, to the plain merge of
   the previous pack and the step's batch (``MergeCheck``); the kernels'
   launch counts are read around exactly this run; then a few more steps
   of the same traffic, timed phase by phase (the step's breakdown);
4. compaction on the card: 1M keys at gamma = 0.001, synchronous and
   background compactions, results and merges checked the same way; then
   the
   ``ShardedIndexEngine``'s maintenance at 1M keys in 8 shards, sync and
   async answering alike: shard-local compaction (only the hot shard
   compacts, cold shards keep their mirror epochs) and online
   repartitioning (drift inserts until the load monitor splits, then a
   merge forced by hand), with no compaction, split or merge build
   failed; then the index mesh at 1M keys in 8 shards, over cuda:0 named
   1, 2 and 4 times (the stand-in for a mesh of cards: it exercises the
   routing, the per-position launches and the installs, not copies
   between cards): ``lookup_batch_sharded_mesh`` (with and without the
   overlay, a window of the whole batch and of the host route's bound)
   and the mesh scans (with and without the overlay) == the one-device K1
   shard route and scans on the same stack, each position's K1 launch ==
   its plain version, one launch a position a read; then a restart from a
   snapshot: the background repartitioning run's lived partition (boundary
   version above 0) saved with ``save_partition`` into a temporary
   directory (deleted after), loaded with ``load_partition`` and served on
   a 4-position mesh for 10 steps, the first reading back every write
   acknowledged before the snapshot, every result checked;
5. the numbers: K1/K2 held once more against their plain versions on the
   main path's own tensors, then both timed with CUDA events at those
   shapes (median launch; L2 flushed and the stream held before each
   launch, long enough for a plain version's hundreds of launches too, so
   ``ms`` and ``plain_ms`` are the device's time alone), their bytes
   bounds, steps/s, p99 step time and peak device memory, each beside the
   card's name and power limit; K2 in steady state (the served pack, a
   512-entry batch, a copy of the engine's spare as the target) against
   its live-entry bound, with its time into a fresh target (a reseed or a
   growth), the full rewrite's bound and the launch floor (a one-element
   fill) beside it;
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
   result and every step's merged pack checked as in phase 3, with the
   launch counts of K1's shard route, K2 and K2's stacked form read around
   exactly this run (the first
   two launched, the stacked form not: one card keeps one flat pack),
   every shard served and no background build failed; the step's
   breakdown and its device time (``torch.profiler``); K1's shard route
   held and timed on the run's own tensors beside the monolithic K1;
6b. the mesh path, after the sharded engine is freed: a
   ``ShardedIndexEngine`` over the same partition (its shards hold every
   write served so far) on cuda:0 named 4 times (2 shards a position),
   serving 25 steps of the same traffic, every result checked against the
   same oracle and every merged pack with ``MergeCheck``; the launches read
   around exactly that run must be K1 2 x 4 a step (one a position a read
   batch), K3 1 (the overlay merge after the gather), K2 1 and K2's
   stacked form 0, and the peak device memory within 2% of the sharded
   path's (one stack); its breakdown and a 3-step profile; K1's
   per-position launches held and timed on the run's last get batch, and
   K3 beside ``torch.searchsorted``;
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
   same KV gathered contiguous (the gather not timed);
9. the contiguous-cache path (``models.model.prefill`` / ``decode_step``
   through ``launch.steps.make_prefill_step`` / ``make_decode_step``): (a)
   on the card == on the CPU on tiny float32 configs of gemma2-9b (int8
   cache, a window shorter than the prompt, softcaps), qwen1.5-32b (int8,
   qkv biases) and qwen2-moe-a2.7b (shared experts); (b) qwen3-4b at full
   width in float32, 4 rows of 64 positions, the same tokens through
   ``decode_step`` over a contiguous cache and ``paged_decode_step`` over
   shuffled pages (K1 translating, K6 attending; their launches read
   around exactly this run), logits within 1e-4 and greedy tokens equal at
   >= 90%; (c)-(e) full width, random weights: gemma2-9b (2 rows, a
   32,768-deep int8 cache, prompts of 16,384 tokens in 16 query chunks,
   32 decode steps), qwen2-moe-a2.7b (8 rows, 4096 deep, prompts of 2048,
   32 steps) and qwen1.5-32b last (70.4 GB of bfloat16 weights; 1 row,
   2048 deep, a prompt of 1024, 8 steps), each with layer 0's cache rows
   held bit for bit to its k/v recomputed (``_quant``'s codes and scales
   for int8) and decode after a prefill of S-1 tokens held to the forward
   over S (cosine > 0.95); prefill and decode tokens/s, p50/p99 step ms,
   peak memory;
10. the ssm, hybrid, audio and vlm families on the contiguous path
   (``families_phase``, plain PyTorch, no kernel): (a) ``forward``,
   ``prefill`` and 4 ``decode_step``s on the card == on the CPU for
   float32 reduced configs of rwkv6-1.6b, zamba2-1.2b, musicgen-medium and
   llama-3.2-vision-11b (logits, caches with the vlm's xk/xv, float32
   states within 1e-4, 2e-3 for rwkv6 and zamba2; bfloat16 shift and conv
   rows equal or one ulp apart); (b) each at full width and depth (seeded
   random float32 weights), freed before the next: rwkv6's chunked forward
   over 8 x 4096 tokens and greedy decode from a zero state at 128 rows
   (32 steps) and 1 (8); zamba2's long_500k uncut (1 row, its 7-row
   shared-attention cache 524,288 deep filled with seeded bfloat16 values,
   8 steps at positions 524,280-524,287), then a prefill of 2 x 4096 into
   8192 and 32 steps; musicgen (2 x 8192 seeded bfloat16 frames into
   16,384, 32 steps on token ids) and the vlm (2 x 8192 tokens with 1601
   seeded patches into 16,384, 32 steps); each with prefill and decode
   tokens/s, p50/p99 step ms, device ms and kernels a step
   (``_device_profile``) and peak memory; (c) the cache rows of attention
   row 0 (zamba2's shared block) and the vlm's xk/xv bit for bit, and the
   decoded logits against the forward's: S-1 prefilled and the last
   decoded (audio: frames equal to the tokens' embedding rows; vlm: with
   patches; S = 256; cosine > 0.95), or every position decoded from a zero
   state (ssm, hybrid; S = 64) in float32 with a float32 cache and rows
   (cosine > 0.9999; the configured bfloat16 run's cosine recorded: its
   roundings grow through the random deep stack); then the ``kernels``
   line (K6's long-context numbers, its served ones under
   ``served``; K1's shard route under K1's ``sharded`` and its launches on
   the mesh path under ``mesh``; K2's stacked form under K2's ``stacked``,
   its mesh form under that entry's ``mesh``; K3 on the mesh path under
   K3's ``mesh``) and, last, ``{"ok": true, "device": {...}}``.

It exits non-zero without CUDA and when run outside a checkout of the
repository (it imports the port from ``src/`` beside it).
"""
from __future__ import annotations

import gc
import json
import os
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
FORMS = ("fused_lookup_sharded", "overlay_merge_stacked",
         "fused_lookup_sharded_mesh", "overlay_merge_stacked_mesh")
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
# the index mesh on the one card: cuda:0 named MESH_D times (the stand-in
# for a mesh of cards); parity at each of MESH_PARITY_D positions
MESH_D = 4
MESH_PARITY_D = (1, 2, 4)
MESH_STEPS = 25
RESTART_STEPS = 10
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
# phase 9, the contiguous-cache path: (a) card == CPU on tiny configs,
# (b) paged == contiguous on qwen3-4b at full width, (c)-(e) full-width runs
CONTIG_TINY = ("gemma2-9b", "qwen1.5-32b", "qwen2-moe-a2.7b")
CONTIG_TOL = 1e-4                # (a): logits, float32 on both devices
# (a) at a step where an int8 code of the new token parted (one step of
# one k or v entry moved a reduced gemma2 stack's hidden state by 9.7e-4 in
# tests/test_torch_contiguous.py)
CONTIG_FLIP_TOL = 2e-3
PAGED_ROWS, PAGED_STEPS, PAGED_PAGE = 4, 64, 16
PAGED_TOL = 1e-4                 # (b): logits, float32 pool and cache
# arch -> (rows, cache depth, prompt, decode steps, consistency check's S);
# run in this order, qwen1.5-32b's 70.4 GB of weights last
FULL_RUNS = {"gemma2-9b": (2, 32768, 16384, 32, 4608),
             "qwen2-moe-a2.7b": (8, 4096, 2048, 32, 256),
             "qwen1.5-32b": (1, 2048, 1024, 8, 1024)}
COSINE_MIN = 0.95                # tests/test_models.py's prefill == decode
# phase 10, the ssm, hybrid, audio and vlm families on the contiguous path:
# (a) card == CPU on float32 reduced configs, 4 decode steps
FAMILY_ARCHS = ("rwkv6-1.6b", "zamba2-1.2b", "musicgen-medium",
                "llama-3.2-vision-11b")
FAMILY_STEPS = 4
# (a) rwkv6 and zamba2 part further than CONTIG_TOL where an op amplifies
# float32 summation order (tests/test_torch_families.py): rwkv6's ln_x
# group norm at a head whose bonus term nearly cancels (mean(out^2) below
# its eps of 1e-6, gain up to 1000), zamba2's exp(cum_t - cum_s) of two
# float32 cumulative sums carried through 12 layers (3.8e-4 on the CPU)
FAMILY_TOL = {"rwkv6-1.6b": 2e-3, "zamba2-1.2b": 2e-3,
              "musicgen-medium": CONTIG_TOL,
              "llama-3.2-vision-11b": CONTIG_TOL}
# (b) full width: rwkv6's forward over 8 x 4096 (prefill_32k cut from 32 x
# 32,768), decode at decode_32k's 128 rows and long_500k's 1; zamba2's
# long_500k uncut (its 7-row shared-attention cache 524,288 deep) and a
# prefill of 2 x 4096 into 8192; musicgen and the vlm 2 rows of 8192 into
# 16,384, the vlm with 1601 patches; (c) decode-all-positions length
RWKV_FORWARD = (8, 4096)
RWKV_DECODE = ((128, 32), (1, 8))            # (rows, steps)
ZAMBA_LONG = (1, 524_288, 8)                 # (rows, cache depth, steps)
ZAMBA_PREFILL = (2, 8192, 4096, 32)          # (rows, depth, prompt, steps)
AV_RUN = (2, 16_384, 8192, 32)               # musicgen, vlm
FAMILY_CONSISTENCY_S = {"ssm": 64, "hybrid": 64, "audio": 256, "vlm": 256}
# (c) the recurrent families in float32 with float32 rows and cache (rwkv6
# at full width on one H100: 0.99999996-0.99999999 over S = 32 and 64)
RECURRENT_F32_MIN = 0.9999
# (c) as configured (bfloat16), the decode's distance from the float32
# forward, 1 - cosine, at most this many times the bfloat16 forward's plus
# RECURRENT_BF16_SLACK: both paths round the same values to bfloat16 in
# other orders (tests/test_torch_family_decode.py holds the reference and
# the port to it at full depth on the CPU)
RECURRENT_BF16_RATIO = 1.5
RECURRENT_BF16_SLACK = 0.01


# K2's bound: 24 bytes (key, payload, tombstone) for each of these
K2_BOUND_COUNTS = ("live pack entries in, batch entries in, merged entries "
                   "out, padding slots the target needed")


def k2_live_bytes(live: int, batch: int, merged: int, pad: int) -> int:
    """The bytes a merge into a target must move: its live entries in, the
    merged ones out and the target's slots past them that held entries."""
    return 24 * (live + batch + merged + pad)


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
    import torch
    from repro_torch.core.keys import BIASED_MAX
    from repro_torch.core.lookup import empty_overlay_pack, overlay_from_numpy
    from repro_torch.kernels.overlay_merge.ops import (
        merge_overlay_into_torch, merge_overlay_pack_torch, overlay_merge)
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
        exp = merge_overlay_pack_torch(pa, pb, cap_out)
        par.hold("overlay_merge", (got,), (exp,))
        # into a poisoned target: garbage below its fill, padding past it,
        # the fill below and past the merged count
        n_out = int((exp[0] != BIASED_MAX).sum())
        live = int((pa[0] != BIASED_MAX).sum())
        for f_t in (n_out // 2, min(n_out + 100, cap_out)):
            tgt = empty_overlay_pack(cap_out, dev)
            tgt[:, :f_t] = torch.randint(-9, 9, (3, f_t), device=dev)
            ref = tgt.clone()
            n = overlay_merge(pa, pb, cap_out, out=tgt, fill=live,
                              out_fill=f_t)
            n_plain = merge_overlay_into_torch(pa, pb, cap_out, ref, f_t,
                                               live)
            par.hold("overlay_merge", (tgt, n, n), (ref, n_plain,
                                                    n.new_tensor(n_out)))
            par.hold("overlay_merge", (tgt,), (exp,))
        log(f"k2 parity {name}: Ca={a.shape[1]} Cb={b.shape[1]} "
            f"cap_out={cap_out}, fresh and into poisoned targets: exact")


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
    kind (empty rows, all-overlap, tombstones, cap growth), fresh and into
    a poisoned target with a fill a row; then 8 rows of Ca = cap_out = 2^21
    with Cb = 64 (the bytes of the served flat pack), timed like K1/K2 in
    steady state (into a target holding the rows' packs: padding past
    their fills) beside a fresh target and its plain version."""
    import torch
    from repro_torch.core.keys import BIASED_MAX
    from repro_torch.core.lookup import overlay_from_numpy
    from repro_torch.kernels.overlay_merge.ops import (
        merge_overlay_stacked_into_torch, merge_overlay_stacked_torch,
        overlay_merge_stacked)
    rng = np.random.default_rng(4)
    pool = rng.choice(2**62, size=2_600_000, replace=False).astype(np.uint64)

    def stack(rows):
        return torch.stack([overlay_from_numpy(r, dev)["ov_pack"]
                            for r in rows])

    def live(t):
        return (t[:, 0] != BIASED_MAX).sum(1).tolist()
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
        exp = merge_overlay_stacked_torch(pa, pb, cap_out)
        par.hold("overlay_merge_stacked",
                 (overlay_merge_stacked(pa, pb, cap_out),), (exp,))
        fills = [int(f) for f in rng.integers(0, cap_out + 1, len(rows))]
        tgt = torch.full((len(rows), 3, cap_out), 0, dtype=torch.int64,
                         device=dev)
        tgt[:, 0] = BIASED_MAX
        for r, f in enumerate(fills):
            tgt[r, :, :f] = torch.randint(-9, 9, (3, f), device=dev)
        ref = tgt.clone()
        n = overlay_merge_stacked(pa, pb, cap_out, out=tgt, fill=live(pa),
                                  out_fill=fills)
        n_plain = merge_overlay_stacked_into_torch(pa, pb, cap_out, ref,
                                                   fills, live(pa))
        par.hold("overlay_merge_stacked", (tgt, n, n),
                 (ref, n_plain, n.new_tensor(live(exp))))
        par.hold("overlay_merge_stacked", (tgt,), (exp,))
    log("k2 stacked parity S=8 (empty rows, all-overlap, tombstones, cap "
        "growth), cap_out 8192 and 16384, fresh and into poisoned targets "
        "with a fill a row: exact")
    ca, cb = 1 << 21, 64
    big = [(_pack(rng, pool[i * 300_000:i * 300_000 + 3520], ca),
            _pack(rng, pool[i * 300_000 + 3500:i * 300_000 + 3564], cb))
           for i in range(SHARDS)]
    pa, pb = stack([a for a, _ in big]), stack([b for _, b in big])
    fills = live(pa)
    exp = merge_overlay_stacked_torch(pa, pb, ca)
    par.hold("overlay_merge_stacked", (overlay_merge_stacked(pa, pb, ca),),
             (exp,))
    tgt, ref = pa.clone(), pa.clone()
    n = overlay_merge_stacked(pa, pb, ca, out=tgt, fill=fills,
                              out_fill=fills)
    n_plain = merge_overlay_stacked_into_torch(pa, pb, ca, ref, fills, fills)
    par.hold("overlay_merge_stacked", (tgt, n, n),
             (ref, n_plain, n.new_tensor(live(exp))))
    par.hold("overlay_merge_stacked", (tgt,), (exp,))
    del ref
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    km = time_cuda(lambda: overlay_merge_stacked(
        pa, pb, ca, out=tgt, fill=fills, out_fill=fills), 50, flush)
    fm = time_cuda(lambda: overlay_merge_stacked(pa, pb, ca, fill=fills),
                   20, flush)
    pm = time_cuda(lambda: merge_overlay_stacked_into_torch(
        pa, pb, ca, tgt, fills, fills), 5, flush, PLAIN_HOLD_CYCLES)
    n_in, nb, n_out = sum(fills), sum(live(pb)), sum(live(exp))
    out = {"card": card, "rows": SHARDS, "Ca": ca, "Cb": cb, "cap_out": ca,
           "live": n_in, "batch_live": nb, "merged": n_out,
           "ms": float(np.median(km)), "mean_ms": float(km.mean()),
           "fresh_ms": float(np.median(fm)),
           "plain_ms": float(np.median(pm)),
           "bound_ms": bound_ms(k2_live_bytes(n_in, nb, n_out, 0)),
           "bound_by": "bytes", "bound_counts": K2_BOUND_COUNTS,
           "library_ms": None}
    log(f"k2 stacked parity S={SHARDS} Ca=cap_out={ca} Cb={cb}: exact; "
        "timed in steady state (fresh target: fresh_ms): " + json.dumps(out))
    log(f"k2 stacked into a fresh target: median {out['fresh_ms']} ms "
        "against the full rewrite's bound "
        f"{bound_ms(24 * (n_in + nb) + 24 * SHARDS * ca)} ms")
    out["mesh"] = k2_stacked_mesh(par, dev, pa, pb, ca, exp, flush)
    out["mesh"]["bound_ms"] = bound_ms(24 * (n_in + nb) + 24 * SHARDS * ca)
    return out


def k2_stacked_mesh(par: Parity, dev, pa, pb, ca: int, exp, flush) -> dict:
    """K2's stacked form on the index mesh (``overlay_merge_stacked_mesh``:
    each position merges its own rows) == the one-launch stacked form on
    the card == the plain merge, on the timed rows, over cuda:0 named D
    times for D in MESH_PARITY_D, one launch a position; then timed at
    MESH_D positions into fresh packs (the mesh form's only output)
    beside the plain merge."""
    from repro_torch.kernels.overlay_merge.ops import (
        merge_overlay_stacked_torch, overlay_merge_stacked,
        overlay_merge_stacked_mesh)
    from repro_torch.parallel import index_mesh
    one = overlay_merge_stacked(pa, pb, ca)
    for D in MESH_PARITY_D:
        mesh = index_mesh(D, devices=[dev] * D)
        n0 = overlay_merge_stacked_mesh.launches
        got = overlay_merge_stacked_mesh(mesh, pa, pb, ca)
        if overlay_merge_stacked_mesh.launches - n0 != D:
            raise AssertionError(f"k2 stacked mesh D={D}: "
                                 f"{overlay_merge_stacked_mesh.launches - n0}"
                                 " launches, not one a position")
        par.hold("overlay_merge_stacked_mesh", (got,), (one,))
        par.hold("overlay_merge_stacked_mesh", (got,), (exp,))
        log(f"k2 stacked mesh parity S={pa.shape[0]} over {D} positions of "
            f"{pa.device}: == overlay_merge_stacked == the plain merge; "
            f"launches at each position {[1] * D}")
    del one, got
    mesh = index_mesh(MESH_D, devices=[dev] * MESH_D)
    mm = time_cuda(lambda: overlay_merge_stacked_mesh(mesh, pa, pb, ca), 20,
                   flush)
    pm = time_cuda(lambda: merge_overlay_stacked_torch(pa, pb, ca), 5, flush,
                   PLAIN_HOLD_CYCLES)
    return {"name": "overlay_merge_stacked_mesh", "route": "cuda",
            "source": K2_SOURCE, "replaces": K2_REPLACES,
            "positions": MESH_D, "ms": float(np.median(mm)),
            "mean_ms": float(mm.mean()), "plain_ms": float(np.median(pm)),
            "bound_by": "bytes", "library_ms": None}


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


class MergeCheck:
    """Inside ``with``: every ``merge_overlay_pack`` of the engines (the
    step's K2 launch) is recorded, and :meth:`check`, called after the
    step (outside its timer), holds each merged pack to
    ``merge_overlay_pack_torch(previous pack, batch, cap_out)``, exactly:
    the merge into the engine's spare equals a fresh merge, padding and
    all.  The previous pack is intact until the next step's merge, which
    writes into it.  The plain merge's temporaries stay out of the run's
    peak memory: ``peak`` keeps the peak before each check, and the
    counter restarts after it."""

    def __init__(self, par: Parity):
        self.par, self.pending, self.merges, self.peak = par, [], 0, 0
        self.batch_entries = self.overwrites = 0

    def __enter__(self):
        from repro_torch.serving import index_engine, sharded_engine
        self.mods = (index_engine, sharded_engine)
        self.orig = index_engine.merge_overlay_pack

        def recorded(ovr, batch, cap_out, live=None):
            new, nbytes = self.orig(ovr, batch, cap_out, live)
            self.pending.append((ovr["ov_pack"], batch, cap_out,
                                 new["ov_pack"]))
            return new, nbytes
        for m in self.mods:
            m.merge_overlay_pack = recorded
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.merge_overlay_pack = self.orig
        self.pending.clear()

    def check(self) -> None:
        import torch
        from repro_torch.core.delta_overlay import next_pow2
        from repro_torch.core.keys import BIASED_MAX
        from repro_torch.core.lookup import overlay_from_numpy
        from repro_torch.kernels.overlay_merge.ops import (
            merge_overlay_pack_torch)
        self.peak = max(self.peak, torch.cuda.max_memory_allocated())
        for prev, (bk, bp, bt), cap_out, got in self.pending:
            n = bk.shape[0]
            bpack = np.zeros((3, next_pow2(max(n, 8))), dtype=np.uint64)
            bpack[0] = np.uint64(2**64 - 1)
            bpack[:, :n] = np.stack([bk, bp, np.asarray(bt, np.uint64)])
            batch = overlay_from_numpy(bpack, prev.device)["ov_pack"]
            exp = merge_overlay_pack_torch(prev, batch, cap_out)
            self.par.hold("overlay_merge", (got,), (exp,))
            self.merges += 1
            self.batch_entries += n
            self.overwrites += n + int((prev[0] != BIASED_MAX).sum()) \
                - int((exp[0] != BIASED_MAX).sum())
            del exp, batch
        # nothing of the check is held when the peak counter restarts
        prev = got = None
        self.pending.clear()
        torch.cuda.reset_peak_memory_stats()

    def overwrite_share(self) -> float:
        """The share of the merged batch entries whose key the pack held
        already (an update or a delete of an overlay key)."""
        return self.overwrites / max(self.batch_entries, 1)

    def max_memory_allocated(self) -> int:
        """The run's peak device memory without the checks'."""
        import torch
        return max(self.peak, torch.cuda.max_memory_allocated())


def serve_and_check(eng, oracle: Oracle, trace: list,
                    merges: MergeCheck | None = None) -> list:
    """Run every step of ``trace`` through ``eng`` and check each result
    against the oracle, and each step's overlay merge with ``merges``
    (the checks sit outside the engine's step timer).  Returns every (op,
    key, result)."""
    out = []
    for si, step in enumerate(trace):
        reqs = [eng.submit(*r) for r in step]
        eng.step()
        if merges is not None:
            merges.check()
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


def main_path(n: int, steps: int, dev, card: str, par: Parity) -> dict:
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
    with MergeCheck(par) as merges:
        fused_lookup.launches = 0
        overlay_merge.launches = 0
        serve_and_check(eng, oracle, trace, merges)
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
        "max_memory_allocated_bytes": int(merges.max_memory_allocated()),
        "overwrite_share": merges.overwrite_share(),
        "overlay_merges": st["overlay_merges"],
        "compactions": st["compactions"],
        "read_backend": st["read_backend"],
        "launches": launches, "merges_held": merges.merges,
        "checked": "every get, write and scan result equals the oracle; "
                   "every merged pack equals the plain merge",
    }
    log("main path: " + json.dumps(out))
    if merges.merges != st["overlay_merges"]:
        raise AssertionError(f"main path: {merges.merges} merges held of "
                             f"{st['overlay_merges']}")
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
    is admission and bookkeeping.  Each device phase's temporaries (its
    peak device memory above what was allocated when it began, outside the
    timers) are logged beside."""
    import torch
    acc = {"host_writes": 0.0, "overlay_merge": 0.0, "gets": 0.0,
           "scans": 0.0}
    temps = {"overlay_merge": 0, "gets": 0, "scans": 0}

    def timed(name, fn, sync):
        def run(*a, **kw):
            if sync:
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            t = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            acc[name] += time.perf_counter() - t
            if sync:
                temps[name] = max(temps[name],
                                  torch.cuda.max_memory_allocated() - base)
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
    log("device temporaries by phase (peak bytes above the allocation at "
        "its start): " + json.dumps(temps))
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


def compaction_phase(dev, par: Parity) -> None:
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
        with MergeCheck(par) as merges:
            for i in range(8):
                serve_and_check(eng, oracle,
                                [make_step(rng, keys, lo, hi, 1024, 512, 8)],
                                merges)
                if i % 2:       # let every second step's build land
                    eng.drain_compactions()
            serve_and_check(eng, oracle, [make_step(rng, keys, lo, hi, 1024,
                                                    0, 8)], merges)
        st = eng.stats()
        log(f"compaction {mode}: compactions={st['compactions']} "
            f"swaps={st['swaps']} full_builds={st['mirror_full_builds']} "
            f"overlay_merges={st['overlay_merges']} "
            f"reseeds={st['overlay_reseeds']}: every result and merged "
            "pack checked")
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
    with MergeCheck(par) as merges:
        fused_lookup_sharded.launches = 0
        overlay_merge.launches = 0
        overlay_merge_stacked.launches = 0
        serve_and_check(eng, oracle, trace, merges)
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
        "max_memory_allocated_bytes": int(merges.max_memory_allocated()),
        "stack_bytes": stack_bytes(eng.stk),
        "overwrite_share": merges.overwrite_share(),
        "setup_s": {"bulkload": t1 - t0, "mirror_stack_upload": t2 - t1},
        "gets_per_shard": per_shard.tolist(),
        "compactions": st["compactions"],
        "overlay_merges": st["overlay_merges"],
        "overlay_reseeds": st["overlay_reseeds"],
        "failed_swaps": st["failed_swaps"],
        "repart_failures": st["repart_failures"],
        "read_backend": st["read_backend"], "launches": launches,
        "merges_held": merges.merges,
        "checked": "every get, write and scan result equals the oracle; "
                   "every merged pack equals the plain merge",
    }
    log("sharded path: " + json.dumps(out))
    if merges.merges != st["overlay_merges"]:
        raise AssertionError(f"sharded path: {merges.merges} merges held of "
                             f"{st['overlay_merges']}")
    for k in ("fused_lookup_sharded", "overlay_merge"):
        if launches[k] == 0:
            raise AssertionError(f"{k} was not launched on the sharded path")
    # the engines keep one flat overlay pack, on the mesh too: no engine
    # merges stacked packs (nor does the reference's)
    if launches["overlay_merge_stacked"]:
        raise AssertionError("overlay_merge_stacked ran on the sharded path")
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
    # what the mesh path serves on: the partition (its shards hold every
    # write served so far), the oracle and the traffic; not the engine
    return out, {"part": part, "oracle": oracle, "make": make}


def mesh_phase(state: dict, sh: dict, dev, card: str, par: Parity) -> dict:
    """The mesh path at full size, after the sharded path's engine is
    freed: a ``ShardedIndexEngine`` over the same partition on the index
    mesh (cuda:0 named MESH_D times: 2 shards a position) serving
    MESH_STEPS steps of the same skewed traffic, every result checked
    against the same oracle and every merged pack with ``MergeCheck``; the
    launches of K1 (one a position a read batch), K3, K2 and K2's stacked
    form read around exactly that run; the peak device memory held within
    2% of the sharded path's (one stack); the step's breakdown and a
    3-step profile; then K1's per-position launches held and timed on the
    run's last get batch beside their plain versions, and K3 at the same
    batch beside ``torch.searchsorted``."""
    import torch
    from repro_torch.core.keys import keys_to_tensor
    from repro_torch.kernels.fused_lookup.ops import (
        fused_lookup_sharded, fused_lookup_sharded_mesh, k1_bytes, k1_walks,
        lookup_sharded_plain)
    from repro_torch.kernels.overlay_merge.ops import (
        overlay_merge, overlay_merge_stacked, overlay_merge_stacked_mesh)
    from repro_torch.kernels.overlay_probe.ops import (k3_bytes,
                                                       overlay_probe,
                                                       overlay_probe_plain)
    from repro_torch.parallel import index_mesh
    from repro_torch.serving import ShardedIndexEngine, pad_queries

    part, oracle, make = state["part"], state["oracle"], state["make"]
    log(f"mesh path: {part.n_items} keys in {part.num_shards} shards on "
        f"{MESH_D} positions of {dev}, {MESH_STEPS} steps")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mesh = index_mesh(MESH_D, devices=[dev] * MESH_D)
    eng = ShardedIndexEngine(part, mesh=mesh)        # gamma = 0.05
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    stk = eng.stk
    log(f"mesh set-up: mirrored, stacked on the host and placed in "
        f"{setup_s:.3f} s (a position's leaf pool "
        f"{tuple(stk['leaf_keys'][0].shape)}, {len(stk['leaf_keys'])} "
        f"positions; overlay pack {tuple(eng.ov_arrs['ov_pack'].shape)})")
    rng = np.random.default_rng(41)
    trace = [make(rng) for _ in range(MESH_STEPS)]
    counters = (fused_lookup_sharded, fused_lookup_sharded_mesh,
                overlay_probe, overlay_merge, overlay_merge_stacked,
                overlay_merge_stacked_mesh)
    with MergeCheck(par) as merges:
        for c in counters:
            c.launches = 0
        serve_and_check(eng, oracle, trace, merges)
        launches = {c.__name__: c.launches for c in counters}
    st = eng.stats()
    step_s = np.asarray(eng.step_seconds)
    peak = int(merges.max_memory_allocated())
    out = {
        "card": card, "keys": int(part.n_items), "shards": part.num_shards,
        "mesh_devices": st["mesh_devices"], "steps": st["steps"],
        "requests": sum(len(s) for s in trace),
        "steps_per_s": st["steps"] / eng.serve_seconds,
        "p50_step_ms": float(np.percentile(step_s, 50)) * 1e3,
        "p99_step_ms": float(np.percentile(step_s, 99)) * 1e3,
        "first_step_ms": float(step_s[0]) * 1e3,
        "max_memory_allocated_bytes": peak,
        "stack_bytes": stack_bytes(stk),
        "sharded_peak_bytes": sh["max_memory_allocated_bytes"],
        "sharded_stack_bytes": sh["stack_bytes"],
        "overwrite_share": merges.overwrite_share(),
        "setup_s": setup_s, "overlay_merges": st["overlay_merges"],
        "overlay_reseeds": st["overlay_reseeds"],
        "compactions": st["compactions"], "launches": launches,
        "merges_held": merges.merges,
        "checked": "every get, write and scan result equals the oracle; "
                   "every merged pack equals the plain merge",
    }
    log("mesh path: " + json.dumps(out))
    steps = MESH_STEPS
    want = {"fused_lookup_sharded_mesh": 2 * MESH_D * steps,
            "fused_lookup_sharded": 2 * MESH_D * steps,
            "overlay_probe": steps, "overlay_merge": steps,
            "overlay_merge_stacked": 0, "overlay_merge_stacked_mesh": 0}
    if launches != want:
        raise AssertionError(f"mesh path launches {launches}, want {want}")
    if merges.merges != st["overlay_merges"]:
        raise AssertionError(f"mesh path: {merges.merges} merges held of "
                             f"{st['overlay_merges']}")
    _no_failed_builds(st, "mesh path")
    # the partition has lived: its hot shard's leaf rows may have crossed
    # the stack's pow2 headroom (stack_device_indexes), so the stack may be
    # larger than the sharded path's; above the stack, the peak must be the
    # sharded path's within 2% of it: a stack held twice fails this
    expect = sh["max_memory_allocated_bytes"] - sh["stack_bytes"] \
        + out["stack_bytes"]
    if abs(peak - expect) > 0.02 * sh["max_memory_allocated_bytes"]:
        raise AssertionError(f"mesh path peak {peak} bytes is not within 2% "
                             f"of the sharded path's "
                             f"{sh['max_memory_allocated_bytes']} over a "
                             f"stack of {out['stack_bytes']} bytes (the "
                             f"sharded one {sh['stack_bytes']})")
    out["breakdown_s"] = breakdown(eng, oracle, make, 5)
    out["profile"] = index_profile(eng, oracle, make, 3, "mesh path")
    _no_failed_builds(eng.stats(), "mesh path")

    # K1 at each position and K3 on the run's own tensors: the last get
    # batch, routed as the engine routes it
    ovr, h = eng.ov_arrs, eng._height()
    qn = pad_queries([r[1] for r in trace[-1] if r[0] == "get"])
    q = keys_to_tensor(qn, dev)
    eng._route_q = qn
    qcap = eng._mesh_qcap(stk)
    wins = _mesh_windows(stk, q, qcap, eng.sdi.meta.shape[0] // MESH_D,
                         mesh)
    for local, qwin in wins:
        par.hold("fused_lookup_sharded",
                 fused_lookup_sharded(local, None, qwin, h),
                 lookup_sharded_plain(local, None, qwin, h))
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    km = time_cuda(lambda: [fused_lookup_sharded(lo, None, qw, h)
                            for lo, qw in wins], 50, flush)
    pm = time_cuda(lambda: [lookup_sharded_plain(lo, None, qw, h)
                            for lo, qw in wins], 10, flush,
                   PLAIN_HOLD_CYCLES)
    cm = time_cuda(lambda: fused_lookup_sharded_mesh(mesh, stk, q, h, qcap),
                   20, flush, PLAIN_HOLD_CYCLES)
    nbytes = 0
    for lo, qw in wins:
        leaf = fused_lookup_sharded(lo, None, qw, h)[2]
        nbytes += k1_bytes(qw.shape[0], k1_walks(lo, qw),
                           int(torch.unique(leaf).numel()),
                           lo["leaf_keys"].shape[2], False, True,
                           lo["bounds"].numel())
    out["k1"] = {"name": "fused_lookup_sharded_mesh", "route": "cuda",
                 "source": K1_SOURCE, "replaces": K1S_REPLACES,
                 "positions": MESH_D, "Q": q.shape[0], "qcap": qcap,
                 "window": wins[0][1].shape[0],
                 "launches": launches["fused_lookup_sharded_mesh"],
                 "launches_per_position_per_step": 2,
                 "max_abs_err": par.err["fused_lookup_sharded"],
                 "ms": float(np.median(km)), "mean_ms": float(km.mean()),
                 "plain_ms": float(np.median(pm)),
                 "call_ms": float(np.median(cm)),
                 "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
                 "library_ms": None}
    log(f"k1 mesh on the mesh path ({MESH_D} launches, one a position, "
        f"windows of {wins[0][1].shape[0]} of Q={q.shape[0]}): each == its "
        f"plain version; timed on {card} (ms: the {MESH_D} launches; "
        f"call_ms: the whole mesh read, routing included): "
        + json.dumps(out["k1"]))
    got = overlay_probe(ovr, q)
    par.hold("overlay_probe", got, overlay_probe_plain(ovr, q))
    keys = ovr["ov_pack"][0]
    k3m = time_cuda(lambda: overlay_probe(ovr, q), 50, flush)
    k3p = time_cuda(lambda: overlay_probe_plain(ovr, q), 10, flush,
                    PLAIN_HOLD_CYCLES)
    k3l = time_cuda(lambda: torch.searchsorted(keys, q), 50, flush)
    out["k3"] = {"name": "overlay_probe", "route": "cuda",
                 "source": STAGED["overlay_probe"][0],
                 "replaces": STAGED["overlay_probe"][1],
                 "Q": q.shape[0], "pack": keys.shape[0],
                 "launches": launches["overlay_probe"],
                 "max_abs_err": par.err["overlay_probe"],
                 "ms": float(np.median(k3m)), "mean_ms": float(k3m.mean()),
                 "plain_ms": float(np.median(k3p)),
                 "bound_ms": bound_ms(k3_bytes(q.shape[0],
                                               int(got[1].sum()))),
                 "bound_by": "bytes",
                 "library_ms": float(np.median(k3l))}
    log(f"k3 on the mesh path (Q={q.shape[0]}, pack {keys.shape[0]}): == "
        f"its plain version; timed on {card}: " + json.dumps(out["k3"]))
    return out


def stack_bytes(stk: dict) -> int:
    """Device bytes of a (placed or one-device) stack's tensors, each
    storage once: a mesh that names one card several times shares its
    replicated fields."""
    import torch
    seen = {}
    for v in stk.values():
        for t in (v if isinstance(v, tuple) else (v,)):
            if torch.is_tensor(t):
                seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


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


def sharded_maintenance(dev) -> dict:
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
    # the background run's partition, lived (split, then merged) and
    # holding every acknowledged write, for the restart from a snapshot
    return {"part": eng.part, "oracle": oracle, "keys": keys}


def _mesh_windows(stk: dict, q, qcap, Sl: int, mesh) -> list:
    """Each position's K1 operands and window of the batch ``q``, as
    ``fused_lookup_sharded_mesh`` builds them: (local stack, window)."""
    import torch
    from repro_torch.core.keys import BIASED_MAX
    from repro_torch.kernels.fused_lookup.ops import _mesh_window, _position
    window = q.shape[0] if qcap is None \
        else min(max(qcap * Sl, 1), q.shape[0])
    out = []
    for d, dev in enumerate(mesh.devices):
        local = torch.searchsorted(stk["bounds"][d], q.to(dev)) - d * Sl
        owned = (local >= 0) & (local < Sl) & (q.to(dev) != BIASED_MAX)
        out.append((_position(stk, d, Sl), _mesh_window(q.to(dev), owned,
                                                        window)[0]))
    return out


def _same_read(one, got, real, what: str) -> None:
    """A mesh read == the one-device read: found and payload where the
    query is real, leaf rows where found, shard ids where real.  The
    sentinel (2**64 - 1) is owned by no position: a snapshot read gives it
    zeros; merged with the overlay, it hits the pack's padding on both."""
    import torch
    torch.cuda.synchronize()
    ok = torch.equal(got[2][got[1] & real], one[2][got[1] & real])
    if len(one) > 3:
        ok = ok and torch.equal(got[1][real], one[1][real]) \
            and torch.equal(got[0][real], one[0][real]) \
            and torch.equal(got[3][real], one[3][real]) \
            and not got[1][~real].any() and not got[0][~real].any()
    else:
        ok = ok and torch.equal(got[1], one[1]) and torch.equal(got[0],
                                                                one[0])
    if not ok:
        raise AssertionError(f"{what}: mesh read != the one-device read")


def _same_scan(one, got, what: str) -> None:
    import torch
    torch.cuda.synchronize()
    kb, vb, mb = one
    km, vm, mm = got
    if not (torch.equal(mb, mm) and torch.equal(kb[mb], km[mb])
            and torch.equal(vb[mb], vm[mb])):
        raise AssertionError(f"{what}: mesh scan != the one-device scan")


def mesh_parity(par: Parity, dev) -> None:
    """The index mesh on the card at MAINT_KEYS keys in SHARDS shards:
    over cuda:0 named D times (D in MESH_PARITY_D), the mesh read
    (``lookup_batch_sharded_mesh``, with and without the overlay, a window
    of the whole batch and of the host route's bound) and the mesh scans
    (with and without the overlay) == the one-device K1 shard route and
    scans on the same stack, whose slices the placed stack views; each
    position's K1 launch == its plain version on its window; one launch a
    position a read."""
    import torch
    from repro_torch.core import lookup as L
    from repro_torch.core import partition_bulkload
    from repro_torch.core.delta_overlay import next_pow2
    from repro_torch.core.keys import keys_to_tensor
    from repro_torch.core.workloads import make_dataset, payloads_for
    from repro_torch.kernels.fused_lookup.ops import (
        fused_lookup_sharded, fused_lookup_sharded_mesh, lookup_sharded_plain)
    from repro_torch.parallel import index_mesh, place_stacked
    from repro_torch.serving import ShardedIndexEngine
    keys = make_dataset("covid", MAINT_KEYS, seed=5)
    eng = ShardedIndexEngine(partition_bulkload(keys, payloads_for(keys),
                                                SHARDS), device=dev)
    rng = np.random.default_rng(43)
    lo, hi = int(keys[0]), int(keys[-1]) + 1
    serve_and_check(eng, Oracle(keys), [make_step(rng, keys, lo, hi, 1024,
                                                  2048, 8)
                                        for _ in range(2)])
    stk, ovr, h = eng.stk, eng.ov_arrs, eng._height()
    qn = _bound_queries(keys, eng.sdi.bounds, rng, 6000, 2000)
    q = keys_to_tensor(qn, dev)
    real_np = qn != np.uint64(2**64 - 1)
    real = torch.from_numpy(real_np).to(dev)
    # the engine's host route: the most queries one shard owns, bucketed
    load = np.bincount(eng.part.shard_of_batch(qn[real_np]), minlength=SHARDS)
    qcap = min(next_pow2(max(int(load.max()), 8)), qn.size)
    S = stk["meta"].shape[0]
    stk_cpu = {f: v.cpu() if torch.is_tensor(v) else v
               for f, v in stk.items()}
    one = L.lookup_batch_sharded(stk, q, h)
    one_ov = L.lookup_batch_sharded_overlay(stk, ovr, q, h)
    scans = {ov: (L.scan_batch_sharded_overlay(stk, ovr, q[:512], count=100,
                                               height=h, ov_bound=4096)
                  if ov else L.scan_batch_sharded(stk, q[:512], count=100,
                                                  height=h))
             for ov in (False, True)}
    for D in MESH_PARITY_D:
        mesh = index_mesh(D, devices=[dev] * D)
        placed = place_stacked(stk, mesh)
        if placed["leaf_keys"][0].data_ptr() != stk["leaf_keys"].data_ptr():
            raise AssertionError("the placed stack copies the pools")
        mesh_cpu = index_mesh(D, devices=["cpu"] * D)
        placed_cpu = place_stacked(stk_cpu, mesh_cpu)
        per = []
        for c in (None, qcap):
            n0 = fused_lookup_sharded_mesh.launches
            got = L.lookup_batch_sharded_mesh(mesh, placed, q, h, c)
            per.append(fused_lookup_sharded_mesh.launches - n0)
            _same_read(one, got, real, f"mesh D={D} qcap={c}")
            # the same mesh read through the plain versions, on the host
            plain = L.lookup_batch_sharded_mesh(mesh_cpu, placed_cpu,
                                                q.cpu(), h, c)
            par.hold("fused_lookup_sharded_mesh", got,
                     [t.to(dev) for t in plain])
            _same_read(one_ov, L.lookup_batch_sharded_overlay_mesh(
                mesh, placed, ovr, q, h, c), real, f"mesh overlay D={D}")
        for local, qwin in _mesh_windows(placed, q, qcap, S // D, mesh):
            par.hold("fused_lookup_sharded",
                     fused_lookup_sharded(local, None, qwin, h),
                     lookup_sharded_plain(local, None, qwin, h))
        _same_scan(scans[False], L.scan_batch_sharded_mesh(
            mesh, placed, q[:512], count=100, height=h, qcap=qcap),
            f"mesh scan D={D}")
        _same_scan(scans[True], L.scan_batch_sharded_overlay_mesh(
            mesh, placed, ovr, q[:512], count=100, height=h, qcap=qcap,
            ov_bound=4096), f"mesh overlay scan D={D}")
        if per != [D, D]:
            raise AssertionError(f"mesh D={D}: {per} launches a read, not "
                                 "one a position")
        log(f"mesh parity {MAINT_KEYS} keys in {SHARDS} shards over {D} "
            f"positions of {dev} (qcap {qcap}, Q={q.shape[0]}, every bound "
            f"+-1): reads, overlay reads, scans and overlay scans == the "
            f"one-device K1 shard route and scans; each position's launch "
            f"== its plain version; launches at each position a read "
            f"{[1] * D}")
        del placed


def restart_phase(snap: dict, dev, par: Parity) -> dict:
    """Restart from a snapshot: phase 4's lived partition (split, then
    merged; boundary version above 0) saved with ``save_partition`` into a
    temporary directory (deleted after), loaded with ``load_partition`` and
    served by a ``ShardedIndexEngine`` on the index mesh (cuda:0 named
    MESH_D times) for RESTART_STEPS steps: the first gets every key written
    before the snapshot (each acknowledged write read back), the rest
    serve mixed traffic; every result equals the oracle."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import (latest_partition_step,
                                        load_partition, save_partition)
    from repro_torch.kernels.fused_lookup.ops import fused_lookup_sharded_mesh
    from repro_torch.parallel import index_mesh
    from repro_torch.serving import ShardedIndexEngine
    part, oracle, keys = snap["part"], snap["oracle"], snap["keys"]
    if part.version <= 0:
        raise AssertionError("the snapshot's partition has not lived")
    tmp = tempfile.mkdtemp(prefix="aulid_snapshot_")
    try:
        t0 = time.perf_counter()
        path = save_partition(tmp, 1, part)
        t1 = time.perf_counter()
        if latest_partition_step(tmp) != 1:
            raise AssertionError("the snapshot is not complete")
        restored = load_partition(path)
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(tmp)
    if restored.version != part.version \
            or not np.array_equal(restored.bounds, part.bounds) \
            or [s.n_items for s in restored.shards] \
            != [s.n_items for s in part.shards]:
        raise AssertionError("the restored partition differs")
    eng = ShardedIndexEngine(restored, mesh=index_mesh(
        MESH_D, devices=[dev] * MESH_D))
    written = np.array(sorted(oracle.writes), dtype=np.uint64)
    rng = np.random.default_rng(47)
    lo, hi = int(keys[0]), int(keys[-1]) + 1
    trace = [[("get", int(k)) for k in written]]
    trace += [make_step(rng, keys, lo, hi, 1024, 512, 8)
              for _ in range(RESTART_STEPS - 1)]
    n0 = fused_lookup_sharded_mesh.launches
    with MergeCheck(par) as merges:
        serve_and_check(eng, oracle, trace, merges)
    st = eng.stats()
    out = {"version": restored.version, "shards": restored.num_shards,
           "keys": int(restored.n_items), "steps": st["steps"],
           "writes_read_back": int(written.size),
           "deleted_of_them": sum(oracle.writes[int(k)] is None
                                  for k in written),
           "save_s": t1 - t0, "load_s": t2 - t1,
           "mesh_devices": st["mesh_devices"],
           "k1_mesh_launches": fused_lookup_sharded_mesh.launches - n0,
           "merges_held": merges.merges,
           "checked": "every result equals the oracle; every write "
                      "acknowledged before the snapshot read back"}
    log("restart from a snapshot: " + json.dumps(out))
    _no_failed_builds(st, "restart")
    if out["k1_mesh_launches"] < MESH_D * RESTART_STEPS:
        raise AssertionError("the restored engine did not read on the mesh")
    return out


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
        merge_overlay_into_torch, merge_overlay_pack_torch, overlay_merge)
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
    # K2 at the main path's shape in steady state: the served pack of the
    # last step, a 512-entry batch, and the engine's spare as the next
    # merge finds it (padding past its fill), cloned so the engine keeps
    # its own
    pack, fill = ovr["ov_pack"], ovr["ov_fill"]
    spare, spare_fill = ovr["ov_spare"]
    live = int((pack[0] != BIASED_MAX).sum())
    spare_live = int((spare[0] != BIASED_MAX).sum())
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
    merged = merge_overlay_pack_torch(pack, batch, cap_out)
    out_live = int((merged[0] != BIASED_MAX).sum())
    par.hold("overlay_merge", (overlay_merge(pack, batch, cap_out),),
             (merged,))
    tgt, ref = spare.clone(), spare.clone()
    n = overlay_merge(pack, batch, cap_out, out=tgt, fill=fill,
                      out_fill=spare_fill)
    n_plain = merge_overlay_into_torch(pack, batch, cap_out, ref, spare_fill,
                                       fill)
    par.hold("overlay_merge", (tgt, n, tgt), (ref, n_plain, merged))
    del ref, merged
    log(f"k2 parity main path (served pack, live {live} of fill bound "
        f"{fill}; spare live {spare_live} of fill bound {spare_fill}; Cb="
        f"{batch.shape[1]}), fresh and into the spare: exact")

    def k2():
        return overlay_merge(pack, batch, cap_out, out=tgt, fill=fill,
                             out_fill=spare_fill)
    k2_ms = time_cuda(k2, 50, flush)
    k2_fresh = time_cuda(lambda: overlay_merge(pack, batch, cap_out,
                                               fill=fill), 20, flush)
    k2_plain = time_cuda(lambda: merge_overlay_into_torch(
        pack, batch, cap_out, tgt, spare_fill, fill), 5, flush,
        PLAIN_HOLD_CYCLES)
    one = torch.zeros(1, dtype=torch.int64, device=dev)
    floor = time_cuda(one.zero_, 50, flush)
    del tgt
    nb = int((batch[0] != BIASED_MAX).sum())
    pad = max(0, spare_live - out_live)
    k2_bytes = k2_live_bytes(live, nb, out_live, pad)
    k2_extra = {"fresh_ms": float(np.median(k2_fresh)),
                "launch_floor_ms": float(np.median(floor)),
                "bound_counts": K2_BOUND_COUNTS, "live": live,
                "batch_live": nb, "merged": out_live,
                "target_live": spare_live, "padding_written": pad}
    log(f"k2 steady state: {live} + {nb} entries in, {out_live} out, "
        f"{pad} padding slots (the spare held {spare_live}): live-entry "
        f"bound {bound_ms(k2_bytes)} ms, median {float(np.median(k2_ms))} "
        "ms")
    log(f"k2 into a fresh target (a reseed or a growth): median "
        f"{k2_extra['fresh_ms']} ms against the full rewrite's bound "
        f"{bound_ms(24 * (live + nb) + 24 * cap_out)} ms; launch floor (one "
        f"one-element fill) {k2_extra['launch_floor_ms']} ms")
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
         "cases": par.cases["overlay_merge"], **k2_extra},
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


# ------------------------------------------------------------------- phase 9
def _tiny_contiguous(arch: str):
    """A float32 reduced config of ``arch`` with a window shorter than the
    prompt (gemma2), nonzero qkv biases (qwen1.5) and a float32 cache
    where the config's is bfloat16, so both devices store the same k/v."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    kw = dict(compute_dtype="float32", sliding_window=min(
        cfg.sliding_window, 32))
    if cfg.kv_cache_dtype != "int8":
        kw["kv_cache_dtype"] = "float32"
    return dataclasses.replace(cfg, **kw)


def _codes_parted(got: dict, exp: dict, what: str) -> int:
    """The int8 codes of ``got`` that differ from ``exp``'s: each by at most
    one, at <= 0.1% of a cache (a value at a rounding boundary may round
    either way); the float entries within CONTIG_TOL."""
    import torch
    parted = 0
    for k, e in exp.items():
        g = got[k].cpu()
        if e.dtype == torch.int8:
            d = (g.int() - e.int()).abs()
            parted += int((d > 0).sum())
            if int(d.max()) > 1 or float((d > 0).float().mean()) > 1e-3:
                raise AssertionError(f"{what}: {k} codes differ")
        elif not torch.allclose(g, e, atol=CONTIG_TOL, rtol=CONTIG_TOL):
            raise AssertionError(f"{what}: {k} cache differs")
    return parted


def contiguous_parity(dev) -> dict:
    """(a) The port's ``prefill`` and ``decode_step`` through the step
    functions on the card (their default device) == on the CPU, on tiny
    configs of CONTIG_TINY: the prefill on the same tokens, then each of 8
    greedy decode steps on the CPU's cache (copied to the card), so both
    quantize only the new token.  Logits within CONTIG_TOL, or within
    CONTIG_FLIP_TOL at a step where an int8 code of the new token parted;
    equal greedy tokens; the caches as ``_codes_parted`` holds them."""
    import copy
    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import model as M
    out = {}
    for arch in CONTIG_TINY:
        cfg = _tiny_contiguous(arch)
        cpu = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        gen = torch.Generator().manual_seed(1)
        for name, p in cpu.named_parameters():
            if name.rsplit(".", 1)[-1] in ("bq", "bk", "bv"):
                p.normal_(generator=gen)
        models = {"cpu": cpu, None: copy.deepcopy(cpu).to(dev)}   # None: cuda:0
        B, S, n = 3, 48, 8
        toks = np.random.default_rng(2).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        logits, caches = {}, {}
        for d, model in models.items():
            logits[d], caches[d] = make_prefill_step(cfg, d)(
                model, {"tokens": toks},
                M.init_zeros(M.cache_specs(cfg, B, S + n), d))
        decodes = {d: make_decode_step(cfg, d) for d in models}
        worst, parted = 0.0, 0
        for t in range(n + 1):
            a, b = logits["cpu"], logits[None].cpu()
            now = _codes_parted(caches[None], caches["cpu"], arch)
            parted += now
            tol = CONTIG_FLIP_TOL if now else CONTIG_TOL
            worst = max(worst, float((a - b).abs().max()))
            if not torch.allclose(b, a, atol=tol, rtol=CONTIG_TOL) \
                    or not torch.equal(a.argmax(-1), b.argmax(-1)):
                raise AssertionError(f"contiguous {arch}: card != CPU at "
                                     f"step {t}")
            if t == n:
                break
            tok = a.argmax(-1).to(torch.int32)[:, None]
            pos = np.full(B, S + t)
            caches[None] = {k: v.to(dev) for k, v in caches["cpu"].items()}
            for d, model in models.items():
                logits[d], _, caches[d], _ = decodes[d](model, tok, pos,
                                                        caches[d], {})
        out[arch] = {"max_logit_diff": worst, "int8_codes_parted": parted,
                     "kv_cache_dtype": cfg.kv_cache_dtype}
    log(f"contiguous parity (tiny float32 configs, a prefill of 48 tokens "
        f"and 8 decode steps, card == CPU: logits within {CONTIG_TOL} "
        f"({CONTIG_FLIP_TOL} at a step that parted an int8 code), equal "
        "greedy tokens): " + json.dumps(out))
    return out


def paged_vs_contiguous(dev, card: str) -> dict:
    """(b) qwen3-4b at full width in float32: the same tokens through
    ``decode_step`` over a contiguous cache and through
    ``paged_decode_step`` over a page table of shuffled physical pages
    (``LearnedPageTable``: K1 translates each step's table, K6 attends),
    PAGED_ROWS rows of PAGED_STEPS positions.  Logits within PAGED_TOL,
    greedy tokens equal at >= 90% of (row, step), as the reference's
    ``TestPagedDecode`` holds them; K1/K6 launch counts read around exactly
    this run."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.fused_lookup.ops import fused_lookup
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.models import model as M
    from repro_torch.serving import LearnedPageTable, PagePool
    from repro_torch.serving.paged_model import (init_page_pool,
                                                 paged_decode_step)
    cfg = dataclasses.replace(get_config(LM_ARCH), compute_dtype="float32",
                              kv_cache_dtype="float32")
    B, n, page = PAGED_ROWS, PAGED_STEPS, PAGED_PAGE
    NP = n // page
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(4),
                          dev)
    cache = M.init_zeros(M.cache_specs(cfg, B, n), dev)
    rng = np.random.default_rng(5)
    table = LearnedPageTable(PagePool(B * NP + 3), dev)
    order = rng.permutation(B * NP)         # allocation order: shuffled pages
    for i in order:
        table.alloc_page(1 + int(i) // NP, int(i) % NP)
    seqs = np.repeat(np.arange(1, B + 1), NP)
    lps = np.tile(np.arange(NP), B)
    exp = np.array([table.translate(int(a), int(b)) for a, b in
                    zip(seqs, lps)])
    pool = init_page_pool(cfg, B * NP + 3, page, dev)
    toks = rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    fused_lookup.launches = 0
    paged_attention.launches = 0
    worst, agree = 0.0, []
    for t in range(n):
        pos = np.full((B,), t, np.int64)
        tables = table.translate_batch(seqs, lps)
        if not np.array_equal(tables.cpu().numpy(), exp):
            raise AssertionError("paged: translate_batch (K1) != the host "
                                 "index")
        dense, _, cache, _ = M.decode_step(cfg, model, toks[:, t:t + 1], pos,
                                           cache, None)
        paged, _ = paged_decode_step(
            cfg, model, toks[:, t:t + 1], pos, pool,
            tables.reshape(B, NP).to(torch.int32), page)
        worst = max(worst, float((paged - dense).abs().max()))
        agree.append(float((paged.argmax(-1) == dense.argmax(-1)).float()
                           .mean()))
    launches = {"fused_lookup": fused_lookup.launches,
                "paged_attention": paged_attention.launches}
    out = {"card": card, "arch": LM_ARCH, "rows": B, "steps": n,
           "page_size": page, "max_logit_diff": worst,
           "greedy_agreement": float(np.mean(agree)), "launches": launches}
    log(f"paged == contiguous at full width (tolerance {PAGED_TOL}): "
        + json.dumps(out))
    if worst > PAGED_TOL or out["greedy_agreement"] < 0.9:
        raise AssertionError("paged decode != contiguous decode")
    if launches != {"fused_lookup": n, "paged_attention": n * cfg.n_layers}:
        raise AssertionError(f"paged == contiguous: launches {launches}")
    del model, cache, pool
    return out


def _cosine(a, b) -> float:
    a, b = a.double(), b.double()
    return float(((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1) + 1e-9)
                  ).min())


def _check_quant(cfg, model, batch: dict, cache, dev) -> str:
    """The cache rows a prefill of ``batch`` wrote for attention row 0 ==
    its k/v recomputed here (``_quant``'s codes and scales for an int8
    cache), bit for bit: layer 0's, or zamba2's shared block's; and the
    vlm's cross k/v == ``cross_kv`` of the patches, every cross layer."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.attention import _project_qkv, _quant, cross_kv
    from repro_torch.models.common import apply_rope, rms_norm
    blk = (model.extras["shared_attn"] if cfg.family == "hybrid"
           else model.layers[0])
    ln = blk.ln if cfg.family == "hybrid" else blk.ln1
    x = M._embed_in(cfg, model, batch, dev)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(
        B, S)
    _, k, v = _project_qkv(cfg, blk.attn, rms_norm(x, ln, cfg.norm_eps))
    k = apply_rope(k, positions, cfg.rope_theta)
    for name, t in (("k", k), ("v", v)):
        if cfg.kv_cache_dtype == "int8":
            q, sc = _quant(t)
            same = torch.equal(cache[name][0, :, :S], q) and torch.equal(
                cache[f"{name}_scale"][0, :, :S], sc)
        else:
            same = torch.equal(cache[name][0, :, :S],
                               t.to(cache[name].dtype))
        if not same:
            raise AssertionError(f"{cfg.name}: row 0's {name} cache rows "
                                 "differ from the prompt's recomputed k/v")
    what = ("_quant codes and scales" if cfg.kv_cache_dtype == "int8"
            else cfg.kv_cache_dtype + " k/v") + " of attention row 0"
    if "xk" in cache:
        memory = M._floats(batch["patches"], dev).to(x.dtype)
        for j, cp in enumerate(model.extras["cross"]):
            k, v = cross_kv(cfg, cp.attn, memory)
            if not (torch.equal(cache["xk"][j], k.to(cache["xk"].dtype))
                    and torch.equal(cache["xv"][j],
                                    v.to(cache["xv"].dtype))):
                raise AssertionError(f"{cfg.name}: cross row {j}'s xk/xv "
                                     "differ from cross_kv of the patches")
        what += f" and xk/xv of {len(model.extras['cross'])} cross layers"
    return what + ", bit for bit"


def _consistency(cfg, model, S: int, dev) -> dict:
    """Greedy decode at position S-1 after a prefill of S-1 tokens == the
    forward over S tokens (tests/test_models.py's check: per-row cosine >
    COSINE_MIN; the moe family dropless, as there, and in float32: in
    bfloat16 a near-tie between a token's 4th and 5th of 60 experts routes
    the two paths apart, cosine 0.9895 and 0.9388 in two runs)."""
    import dataclasses
    import torch
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts),
                                  compute_dtype="float32")
    B = 1 if cfg.family == "dense" else 2
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S))
    full, dec = _decoded_last(cfg, model, {"tokens": toks}, toks, dev)
    cos = _cosine(dec, full)
    if not cos > COSINE_MIN:
        raise AssertionError(f"{cfg.name}: prefill + decode != forward "
                             f"(cosine {cos})")
    return {"rows": B, "S": S, "cosine_min": cos,
            "max_abs_diff": float((dec - full).abs().max()),
            "same_greedy": bool(torch.equal(dec.argmax(-1), full.argmax(-1)))}


def _device_profile(fn, n: int) -> dict:
    """Device time by kernel over ``n`` calls of ``fn`` (``torch.profiler``,
    outside the timed run): device ms a call, the device's busy share of
    their wall time (which the profiler itself slows), kernels a call and
    the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    total = sum(dev_us(e) for e in rows)
    return {"calls": n, "wall_ms": wall / n * 1e3,
            "device_ms": total / n / 1e3, "device_busy_share": total / 1e6
            / wall, "kernels": sum(e.count for e in rows) / n,
            "top_kernels": [{"name": e.key[:70], "calls": e.count // n,
                             "ms": dev_us(e) / n / 1e3}
                            for e in sorted(rows, key=dev_us,
                                            reverse=True)[:6]]}


def full_width_run(arch: str, dev, card: str) -> dict:
    """One config of FULL_RUNS at full width, as configured (random weights
    from a seeded ``torch.Generator``): a prefill of the rows' prompts into
    the cache through ``make_prefill_step``, then greedy decode steps
    through ``make_decode_step``, each step timed to its synchronize; the
    cache rows checked against layer 0's recomputed k/v, and the
    prefill/forward consistency; prefill and decode tokens/s, p50/p99 step
    ms and the peak device memory."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import model as M
    from repro_torch.models.attention import _q_chunk
    B, s_max, prompt, n, S_check = FULL_RUNS[arch]
    cfg = get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    before = int(torch.cuda.memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(7),
                          dev)
    cache = M.init_zeros(M.cache_specs(cfg, B, s_max), dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (B, prompt))
    t = time.perf_counter()
    logits, cache = prefill(model, {"tokens": toks}, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    step_s, tok, cache, _ = _steps_timed(decode, model, B, tok, prompt, n,
                                         cache, {}, arch)
    peak = int(torch.cuda.max_memory_allocated())
    quant = _check_quant(cfg, model, {"tokens": toks}, cache, dev)
    # where the time goes: the prefill once more (it rewrites the same
    # rows), then 2 more decode steps past the timed ones
    prof = {"prefill": _device_profile(
        lambda: prefill(model, {"tokens": toks}, cache), 1)}
    at = iter(range(prompt + n, prompt + n + 2))
    prof["decode"] = _device_profile(
        lambda: decode(model, tok, np.full(B, next(at)), cache, {}), 2)
    del cache, logits
    torch.cuda.empty_cache()
    cons = _consistency(cfg, model, S_check, dev)
    n_params = sum(p.numel() for p in model.parameters())
    out = {"card": card, "arch": arch, "params": n_params,
           "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
           "kv_cache_dtype": cfg.kv_cache_dtype,
           "cache_depth": s_max, "prompt": prompt,
           "prefill_q_chunk": _q_chunk(cfg, prompt),
           "setup_s": setup_s, "prefill_s": prefill_s,
           "prefill_tokens_per_s": B * prompt / prefill_s,
           **_step_stats(step_s, B), "allocated_before_bytes": before,
           "max_memory_allocated_bytes": peak,
           "cache_checked": quant, "consistency": cons, "profile": prof}
    log(f"full width {arch} on {card}: " + json.dumps(out))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def contiguous_phase(dev, card: str) -> dict:
    """Phase 9: (a) card == CPU, (b) paged == contiguous at full width,
    (c)-(e) the FULL_RUNS configs at full width, each freed before the
    next."""
    import torch
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"parity": contiguous_parity(dev),
           "paged": paged_vs_contiguous(dev, card)}
    gc.collect()
    torch.cuda.empty_cache()
    out["runs"] = {arch: full_width_run(arch, dev, card) for arch in FULL_RUNS}
    out["seconds"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------------------ phase 10
def _same_rows(got: dict, exp: dict, tol: float, what: str) -> float:
    """A cache or state on the card == the CPU's: float entries within
    ``tol`` (rtol CONTIG_TOL); each bfloat16 entry equal or one ulp apart,
    or within ``tol`` (the float32 value it rounds parted by that much).
    Returns the largest float difference."""
    import torch
    from repro_torch.models.common import bf16_near
    worst = 0.0
    for k, e in exp.items():
        g = got[k].cpu()
        if g.dtype == torch.bfloat16:
            if not bf16_near(g, e, tol):
                raise AssertionError(f"{what}: bfloat16 {k} rows differ")
        else:
            worst = max(worst, float((g.float() - e.float()).abs().max()))
            if not torch.allclose(g.float(), e.float(), atol=tol,
                                  rtol=CONTIG_TOL):
                raise AssertionError(f"{what}: {k} differs")
    return worst


def _family_batch(cfg, B: int, S: int, seed: int, dev) -> dict:
    """Seeded inputs on ``dev``: token ids, or the audio stub's frames in
    the compute dtype; and the vlm's patches in the compute dtype."""
    import torch
    from repro_torch.models.common import dtype_of
    g = torch.Generator(device=dev).manual_seed(seed)
    cdt = dtype_of(cfg.compute_dtype)
    out = {}
    if cfg.family == "audio":
        out["frames"] = torch.randn((B, S, cfg.d_model), generator=g,
                                    device=dev).to(cdt)
    else:
        out["tokens"] = torch.randint(0, cfg.vocab_size, (B, S),
                                      generator=g, device=dev)
    if cfg.cross_attn_period:
        out["patches"] = torch.randn((B, cfg.n_patches, cfg.d_model),
                                     generator=g, device=dev).to(cdt)
    return out


def families_parity(dev) -> dict:
    """(a) The four families' ``forward``, ``prefill`` and 4 greedy
    ``decode_step``s through the step functions on the card (their default
    device) == on the CPU, on float32 reduced configs (a float32 KV cache)
    with the same seeded inputs: forward hidden states, prefill logits and
    caches (the vlm's xk/xv included), each decode step from the CPU's
    cache and state (copied to the card): logits, the float32 states
    (wkv, ssm) within FAMILY_TOL, the bfloat16 shift and conv rows equal or
    one ulp apart."""
    import copy
    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import model as M
    out = {}
    for arch in FAMILY_ARCHS:
        cfg = _tiny_contiguous(arch)
        tol = FAMILY_TOL[arch]
        cpu = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        models = {"cpu": cpu, None: copy.deepcopy(cpu).to(dev)}
        B, S = 3, 64
        batch = _family_batch(cfg, B, S, 2, "cpu")
        fw = {d: M.forward(cfg, m, batch, device=d)[0].cpu()
              for d, m in models.items()}
        worst = {"forward": float((fw[None] - fw["cpu"]).abs().max())}
        if not torch.allclose(fw[None], fw["cpu"], atol=tol,
                              rtol=CONTIG_TOL):
            raise AssertionError(f"families {arch}: forward card != CPU")
        logits, caches, states = {}, {}, {}
        for d, model in models.items():
            logits[d], caches[d] = make_prefill_step(cfg, d)(
                model, batch, M.init_zeros(M.cache_specs(
                    cfg, B, S + FAMILY_STEPS), d))
            states[d] = M.init_zeros(M.state_specs(cfg, B), d)
        worst["cache"] = _same_rows(caches[None], caches["cpu"], tol,
                                    f"families {arch} prefill")
        decodes = {d: make_decode_step(cfg, d) for d in models}
        worst["logits"], worst["state"] = 0.0, 0.0
        for t in range(FAMILY_STEPS + 1):
            a, b = logits["cpu"], logits[None].cpu()
            worst["logits"] = max(worst["logits"],
                                  float((a - b).abs().max()))
            if not torch.allclose(b, a, atol=tol, rtol=CONTIG_TOL):
                raise AssertionError(f"families {arch}: card != CPU at "
                                     f"step {t}")
            if t:
                worst["state"] = max(worst["state"], _same_rows(
                    states[None], states["cpu"], tol,
                    f"families {arch} step {t}"))
            if t == FAMILY_STEPS:
                break
            tok = a.argmax(-1).to(torch.int32)[:, None]
            pos = np.full(B, S + t)
            caches[None] = {k: v.to(dev, copy=True)
                            for k, v in caches["cpu"].items()}
            states[None] = {k: v.to(dev, copy=True)
                            for k, v in states["cpu"].items()}
            for d, model in models.items():
                logits[d], _, caches[d], states[d] = decodes[d](
                    model, tok, pos, caches[d], states[d])
        out[arch] = {"tolerance": tol, "max_abs_diff": worst,
                     "state": sorted(states["cpu"]),
                     "cache": sorted(caches["cpu"])}
    log(f"families parity (float32 reduced configs, a prefill of 64 "
        f"positions and {FAMILY_STEPS} decode steps, card == CPU): "
        + json.dumps(out))
    return out


def _steps_timed(decode, model, B: int, tok, pos0: int, n: int, cache,
                 state, what: str):
    """``n`` greedy decode steps from position ``pos0``, each timed to its
    synchronize.  Returns (step seconds, the last next-token column,
    cache, state)."""
    import torch
    times = []
    for i in range(n):
        t = time.perf_counter()
        logits, nxt, cache, state = decode(model, tok, np.full(B, pos0 + i),
                                           cache, state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        tok = nxt[:, None]
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{what}: non-finite logits at step {i}")
    return np.asarray(times), tok, cache, state


def _step_stats(step_s: np.ndarray, B: int) -> dict:
    return {"rows": B, "decode_steps": len(step_s),
            "decode_tokens_per_s": B * len(step_s) / float(step_s.sum()),
            "p50_step_ms": float(np.percentile(step_s, 50)) * 1e3,
            "p99_step_ms": float(np.percentile(step_s, 99)) * 1e3,
            "first_step_ms": float(step_s[0]) * 1e3}


def _decoded_last(cfg, model, batch: dict, toks, dev, f32_rows=False):
    """The forward's last logits and the decoded ones: every position
    from a zero state (ssm, hybrid: their prefill does not seed it, as in
    the reference), or the last after a prefill of S-1 (audio, vlm).
    ``f32_rows``: the state's shift and conv rows in float32."""
    import torch
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import model as M
    B, S = toks.shape
    with torch.no_grad():
        x, _, _ = M.forward(cfg, model, batch)
        full = M._head(cfg, model, x[:, -1:])[:, 0]
    del x
    specs = M.state_specs(cfg, B)
    if f32_rows:
        specs = {k: (shape, "float32") for k, (shape, _) in specs.items()}
    cache = M.init_zeros(M.cache_specs(cfg, B, S), dev)
    state = M.init_zeros(specs, dev)
    decode = make_decode_step(cfg)
    if cfg.family in ("ssm", "hybrid"):
        for t in range(S):
            dec, _, cache, state = decode(model, toks[:, t:t + 1],
                                          np.full(B, t), cache, state)
    else:
        pre = {k: (v if k == "patches" else v[:, :S - 1])
               for k, v in batch.items()}
        _, cache = M.prefill(cfg, model, pre, cache)
        dec, _, _, _ = decode(model, toks[:, S - 1:], np.full(B, S - 1),
                              cache, state)
    if not bool(torch.isfinite(dec).all()):
        raise AssertionError(f"{cfg.name}: non-finite decoded logits")
    return full, dec


def _family_consistency(cfg, model, dev) -> dict:
    """(c) At full width, the decoded last logits against the forward's
    (``_decoded_last``; audio: frames equal to the compute-dtype embedding
    rows of the tokens).  Audio and vlm, as configured: cosine >
    COSINE_MIN.  The ssm and hybrid families decode every position, and
    each bfloat16 rounding of a carried value (the shift and conv rows, a
    bfloat16 cache, bfloat16 compute) grows through the random deep stack:
    at full depth on the CPU the reference's own bfloat16 decode parts from
    its forward to cosine 0.66 (zamba2; tests/test_torch_family_decode.py).
    So they are held twice: in float32 compute with a float32 cache and
    float32 rows, decode against forward, cosine > RECURRENT_F32_MIN; and
    as configured, the decode no farther from that float32 forward than
    the configured forward is (RECURRENT_BF16_RATIO, _SLACK)."""
    import dataclasses
    import torch
    from repro_torch.models.common import dtype_of
    B, S = 2, FAMILY_CONSISTENCY_S[cfg.family]
    batch = _family_batch(cfg, B, S, 9, dev)
    toks = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(10))
    if cfg.family == "audio":
        batch["frames"] = model.embed[toks].to(dtype_of(cfg.compute_dtype))
    elif "tokens" in batch:
        batch["tokens"] = toks
    full, dec = _decoded_last(cfg, model, batch, toks, dev)
    out = {"rows": B, "S": S, "cosine_min": _cosine(dec, full),
           "max_abs_diff": float((dec - full).abs().max()),
           "same_greedy": bool(torch.equal(dec.argmax(-1),
                                           full.argmax(-1)))}
    if cfg.family in ("ssm", "hybrid"):
        f32 = dataclasses.replace(cfg, compute_dtype="float32",
                                  kv_cache_dtype="float32")
        full32, dec32 = _decoded_last(f32, model, batch, toks, dev, True)
        out["float32"] = {"cosine_min": _cosine(dec32, full32),
                          "max_abs_diff": float((dec32 - full32).abs().max())}
        if not out["float32"]["cosine_min"] > RECURRENT_F32_MIN:
            raise AssertionError(f"{cfg.name}: float32 decode != forward "
                                 f"({out['float32']})")
        out["to_float32"] = {"forward": _cosine(full, full32),
                             "decode": _cosine(dec, full32)}
        far = {k: 1 - c for k, c in out["to_float32"].items()}
        if not far["decode"] <= (RECURRENT_BF16_RATIO * far["forward"]
                                 + RECURRENT_BF16_SLACK):
            raise AssertionError(f"{cfg.name}: bfloat16 decode farther from "
                                 f"float32 than the forward ({out})")
    elif not out["cosine_min"] > COSINE_MIN:
        raise AssertionError(f"{cfg.name}: decode != forward ({out})")
    return out


def _family_model(arch: str, dev):
    """The config at full width and its model, random weights from a seeded
    ``torch.Generator`` on the card (``init_params``'s rules)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(11),
                          dev)
    return cfg, model


def _prefill_timed(prefill, model, batch: dict, cache: dict):
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = prefill(model, batch, cache)
    torch.cuda.synchronize()
    return logits, cache, time.perf_counter() - t


def _run_line(arch: str, card: str, out: dict, t0: float) -> dict:
    import torch
    out = {"card": card, "arch": arch, **out,
           "max_memory_allocated_bytes": int(torch.cuda.max_memory_allocated()),
           "seconds": time.perf_counter() - t0}
    log(f"family {arch} on {card}: " + json.dumps(out))
    return out


def rwkv_run(dev, card: str) -> dict:
    """rwkv6-1.6b at full width: the chunked forward (``make_prefill_step``
    with its empty cache) over RWKV_FORWARD rows x tokens; greedy decode
    from a zero state at each RWKV_DECODE (rows, steps); one prefill and 2
    decode steps profiled; (c)."""
    t0 = time.perf_counter()
    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import model as M
    arch = "rwkv6-1.6b"
    cfg, model = _family_model(arch, dev)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    B, S = RWKV_FORWARD
    batch = _family_batch(cfg, B, S, 12, dev)
    logits, _, pre_s = _prefill_timed(prefill, model, batch, {})
    out = {"params": sum(p.numel() for p in model.parameters()),
           "forward_rows": B, "forward_tokens": S, "prefill_s": pre_s,
           "prefill_tokens_per_s": B * S / pre_s,
           "profile": {"prefill": _device_profile(
               lambda: prefill(model, batch, {}), 1)}}
    del batch, logits
    for rows, n in RWKV_DECODE:
        state = M.init_zeros(M.state_specs(cfg, rows), dev)
        tok = torch.zeros((rows, 1), dtype=torch.int32, device=dev)
        step_s, tok, _, state = _steps_timed(decode, model, rows, tok, 0, n,
                                             {}, state, arch)
        at = iter(range(n, n + 2))
        out[f"decode_{rows}"] = {
            **_step_stats(step_s, rows),
            "state_bytes": sum(t.numel() * t.element_size()
                               for t in state.values()),
            "profile": _device_profile(lambda: decode(
                model, tok, np.full(rows, next(at)), {}, state), 2)}
        del state
    out["consistency"] = _family_consistency(cfg, model, dev)
    return _run_line(arch, card, out, t0)


def zamba_run(dev, card: str) -> dict:
    """zamba2-1.2b at full width: long_500k uncut (1 row, the shared
    block's 7-row cache ZAMBA_LONG deep filled with seeded random bfloat16
    values, greedy decode at the last positions from a zero state), freed;
    then a prefill of 2 x 4096 into an 8192-deep cache (row 0 of the
    shared block's cache checked) and greedy decode; profiles; (c)."""
    t0 = time.perf_counter()
    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import model as M
    arch = "zamba2-1.2b"
    cfg, model = _family_model(arch, dev)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    out = {"params": sum(p.numel() for p in model.parameters())}
    B, depth, n = ZAMBA_LONG
    cache = M.init_zeros(M.cache_specs(cfg, B, depth), dev)
    g = torch.Generator(device=dev).manual_seed(13)
    for t in cache.values():
        t.normal_(generator=g)
    state = M.init_zeros(M.state_specs(cfg, B), dev)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    step_s, tok, cache, state = _steps_timed(decode, model, B, tok,
                                             depth - n, n, cache, state, arch)
    at = iter([depth - 2, depth - 1])
    out["long_500k"] = {
        **_step_stats(step_s, B), "cache_depth": depth,
        "positions": [depth - n, depth - 1],
        "cache_bytes": sum(t.numel() * t.element_size()
                           for t in cache.values()),
        "max_memory_allocated_bytes": int(torch.cuda.max_memory_allocated()),
        "profile": _device_profile(lambda: decode(
            model, tok, np.full(B, next(at)), cache, state), 2)}
    del cache, state
    gc.collect()
    torch.cuda.empty_cache()
    B, depth, prompt, n = ZAMBA_PREFILL
    batch = _family_batch(cfg, B, prompt, 14, dev)
    cache = M.init_zeros(M.cache_specs(cfg, B, depth), dev)
    logits, cache, pre_s = _prefill_timed(prefill, model, batch, cache)
    checked = _check_quant(cfg, model, batch, cache, dev)
    state = M.init_zeros(M.state_specs(cfg, B), dev)
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    step_s, tok, cache, state = _steps_timed(decode, model, B, tok, prompt,
                                             n, cache, state, arch)
    at = iter(range(prompt + n, prompt + n + 2))
    out["prefill"] = {
        **_step_stats(step_s, B), "cache_depth": depth, "prompt": prompt,
        "prefill_s": pre_s, "prefill_tokens_per_s": B * prompt / pre_s,
        "cache_checked": checked,
        "profile": {"prefill": _device_profile(
            lambda: prefill(model, batch, cache), 1),
            "decode": _device_profile(lambda: decode(
                model, tok, np.full(B, next(at)), cache, state), 2)}}
    del cache, state, batch, logits
    torch.cuda.empty_cache()
    out["consistency"] = _family_consistency(cfg, model, dev)
    return _run_line(arch, card, out, t0)


def av_run(arch: str, dev, card: str) -> dict:
    """musicgen-medium or llama-3.2-vision-11b at full width: AV_RUN rows
    of seeded bfloat16 frames (musicgen) or tokens with seeded patches (the
    vlm) prefilled into the cache, then greedy decode on token ids; the
    cache checked (attention row 0; the vlm's xk/xv); profiles; (c)."""
    t0 = time.perf_counter()
    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import model as M
    cfg, model = _family_model(arch, dev)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    B, depth, prompt, n = AV_RUN
    batch = _family_batch(cfg, B, prompt, 15, dev)
    cache = M.init_zeros(M.cache_specs(cfg, B, depth), dev)
    logits, cache, pre_s = _prefill_timed(prefill, model, batch, cache)
    checked = _check_quant(cfg, model, batch, cache, dev)
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    step_s, tok, cache, _ = _steps_timed(decode, model, B, tok, prompt, n,
                                         cache, {}, arch)
    at = iter(range(prompt + n, prompt + n + 2))
    out = {"params": sum(p.numel() for p in model.parameters()),
           **_step_stats(step_s, B), "cache_depth": depth, "prompt": prompt,
           "prefill_s": pre_s, "prefill_tokens_per_s": B * prompt / pre_s,
           "cache_checked": checked,
           "profile": {"prefill": _device_profile(
               lambda: prefill(model, batch, cache), 1),
               "decode": _device_profile(lambda: decode(
                   model, tok, np.full(B, next(at)), cache, {}), 2)}}
    del cache, batch, logits
    torch.cuda.empty_cache()
    out["consistency"] = _family_consistency(cfg, model, dev)
    return _run_line(arch, card, out, t0)


def _family_summary(r: dict) -> dict:
    """A run's headline numbers: tokens/s, step ms, device ms and kernels a
    step, peak memory, consistency cosine."""
    def one(d: dict) -> dict:
        keep = ("rows", "prefill_tokens_per_s", "decode_tokens_per_s",
                "p50_step_ms", "p99_step_ms", "max_memory_allocated_bytes")
        got = {k: d[k] for k in keep if k in d}
        prof = d.get("profile", {})
        prof = prof.get("decode", prof) if "decode" in prof or \
            "device_ms" in prof else {}
        if prof:
            got["decode_device_ms"] = prof["device_ms"]
            got["decode_kernels"] = prof["kernels"]
        return got
    out = one(r)
    for k in ("decode_128", "decode_1", "long_500k", "prefill"):
        if k in r:
            out[k] = one(r[k])
    out["consistency_cosine"] = r["consistency"]["cosine_min"]
    out["seconds"] = r["seconds"]
    if "float32" in r["consistency"]:
        out["consistency_cosine_float32"] = \
            r["consistency"]["float32"]["cosine_min"]
        out["cosine_to_float32"] = r["consistency"]["to_float32"]
    return out


def families_phase(dev, card: str) -> dict:
    """Phase 10: (a) card == CPU, then the four families at full width
    (b) with their consistency checks (c), each run freed before the
    next."""
    import torch
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"parity": families_parity(dev), "runs": {}}
    out["runs"]["rwkv6-1.6b"] = rwkv_run(dev, card)
    out["runs"]["zamba2-1.2b"] = zamba_run(dev, card)
    for arch in ("musicgen-medium", "llama-3.2-vision-11b"):
        gc.collect()
        out["runs"][arch] = av_run(arch, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def main() -> int:
    # phase 10's vlm prefill holds 40.4 GB of weights and a 17.2 GB float32
    # logits tensor a layer: without expandable segments the caching
    # allocator splits the freed blocks and runs out at 68 GB in use
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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
    mp = main_path(MAIN_KEYS, MAIN_STEPS, dev, card, par)
    lo, hi = mp["span"]
    mp["summary"]["breakdown_s"] = breakdown(
        mp["engine"], mp["oracle"],
        lambda rng: make_step(rng, mp["keys"], lo, hi, 8192, 512, 16), 5)
    compaction_phase(dev, par)
    snap = sharded_maintenance(dev)
    mesh_parity(par, dev)
    restart = restart_phase(snap, dev, par)
    del snap
    kernels = measure(mp, par, dev)
    kernels += staged_phase(mp, par, dev, card)
    s, keys = mp["summary"], mp["keys"]
    del mp                  # free the monolithic index and its tensors
    gc.collect()
    torch.cuda.empty_cache()
    sh, state = sharded_phase(keys, dev, card, par)
    del keys
    gc.collect()            # the sharded engine and its stack
    torch.cuda.empty_cache()
    mesh = mesh_phase(state, sh, dev, card, par)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    kernels[0]["sharded"] = {
        "name": "fused_lookup_sharded", "route": "cuda",
        **sh["k1"], "source": K1_SOURCE, "replaces": K1S_REPLACES,
        "monolithic_ms": kernels[0]["ms"],
        "max_abs_err": par.err["fused_lookup_sharded"],
        "cases": par.cases["fused_lookup_sharded"], "parity": "exact"}
    kernels[0]["mesh"] = {**mesh.pop("k1"),
                          "cases": par.cases["fused_lookup_sharded_mesh"],
                          "parity": "exact"}
    k2s["mesh"].update(
        launches=mesh["launches"]["overlay_merge_stacked_mesh"],
        max_abs_err=par.err["overlay_merge_stacked_mesh"],
        cases=par.cases["overlay_merge_stacked_mesh"], parity="exact")
    kernels[1]["stacked"] = {
        "name": "overlay_merge_stacked", "route": "cuda",
        **k2s, "source": K2_SOURCE, "replaces": K2_REPLACES,
        "launches": sh["launches"]["overlay_merge_stacked"],
        "max_abs_err": par.err["overlay_merge_stacked"],
        "cases": par.cases["overlay_merge_stacked"], "parity": "exact"}
    next(k for k in kernels if k["name"] == "overlay_probe")["mesh"] = \
        mesh.pop("k3")
    lm_parity(dev)
    lm = lm_phase(dev, card, par)
    kernels[0]["lm"] = lm.pop("k1")
    torch.cuda.empty_cache()
    kernels.append(k6_timing(dev, card, par,
                             lm["launches"]["paged_attention"]))
    contig = contiguous_phase(dev, card)
    fam = families_phase(dev, card)
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
    log(f"mesh end to end on {card} ({MESH_D} positions of one card): "
        f"{mesh['steps_per_s']} steps/s, p50 step {mesh['p50_step_ms']} ms, "
        f"p99 step {mesh['p99_step_ms']} ms, peak device memory "
        f"{mesh['max_memory_allocated_bytes']} bytes (sharded "
        f"{sh['max_memory_allocated_bytes']}); restart from a snapshot: "
        f"{restart['writes_read_back']} acknowledged writes read back")
    log(f"lm end to end on {card}: {lm['tokens_per_s']} tokens/s "
        f"({lm['generated_tokens_per_s']} generated), p50 step "
        f"{lm['p50_step_ms']} ms, p99 step {lm['p99_step_ms']} ms, peak "
        f"device memory {lm['max_memory_allocated_bytes']} bytes")
    paged = contig["paged"]
    log(f"lm paged == contiguous on {card}: {LM_ARCH} at full width, "
        f"logits within {paged['max_logit_diff']}, greedy agreement "
        f"{paged['greedy_agreement']}, launches {paged['launches']}")
    for arch, r in contig["runs"].items():
        log(f"lm contiguous {arch} on {card}: prefill "
            f"{r['prefill_tokens_per_s']} tokens/s ({r['rows']} x "
            f"{r['prompt']}), decode {r['decode_tokens_per_s']} tokens/s, "
            f"p50 step {r['p50_step_ms']} ms, p99 step {r['p99_step_ms']} "
            f"ms, peak device memory {r['max_memory_allocated_bytes']} "
            f"bytes, prefill/decode cosine "
            f"{r['consistency']['cosine_min']}")
    for arch, r in fam["runs"].items():
        log(f"lm family {arch} on {card}: " + json.dumps(_family_summary(r)))
    log(f"phase 9 {contig['seconds']:.3f} s; phase 10 "
        f"{fam['seconds']:.3f} s; total "
        f"{time.perf_counter() - t_start:.3f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
