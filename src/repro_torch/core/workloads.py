# Copied from src/repro/core/workloads.py (the port keeps its own copy; its
# dataset recipes de-duplicate with _sorted_unique instead of np.unique).
"""Datasets and workloads from the paper's evaluation (§5.1.2, §5.1.3).

Datasets — the paper uses four real 200M-key datasets picked from the hardness
categories of [34]: COVID (C1 easy), PLANET (C2 normal), GENOME (C3 locally
hard), OSM (C4 globally hard).  The real files are not available offline, so
we generate synthetic datasets *calibrated to the same hardness signal the
paper reports* — the FMCD conflict degree (paper Table 1: COVID 27, PLANET 22,
GENOME 585, OSM 4106).  Hardness ordering C1≈C2 << C3 << C4 is preserved;
absolute sizes are scaled by ``--scale`` (CPU container vs the paper's HDD).

Workloads — W1 Lookup-Only, W2 Scan-Only (range 100), W3 Write-Only,
W4 Read-Heavy (90/10), W5 Balanced (50/50), W6 Write-Heavy (10/90), the
Append-Only workload of §5.4.2 (Table 6), plus the Shifting-Hotspot drift
pattern from "Are Updatable Learned Indexes Ready?" (PAPERS.md): a windowed
zipf insert hotspot whose center advances over the keyspace — the load that
drives the online-repartitioning gate (DESIGN.md §12).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from .interface import OrderedIndex

# --------------------------------------------------------------------- datasets


def _sorted_unique(keys: np.ndarray) -> np.ndarray:
    """``np.unique(keys)`` by a sort and an adjacent-duplicate mask: the
    same array, but numpy 2.3's hash-based ``np.unique`` takes minutes at
    10^8 keys where the sort takes seconds (see PERF.md, Open questions)."""
    keys = np.sort(keys)
    if keys.shape[0] < 2:
        return keys
    return keys[np.concatenate(([True], keys[1:] != keys[:-1]))]


def covid_like(n: int, rng: np.random.Generator) -> np.ndarray:
    """C1: globally & locally easy — near-uniform timestamps."""
    keys = rng.integers(1_500_000_000_000, 1_700_000_000_000, int(n * 1.05),
                        dtype=np.uint64)
    return _sorted_unique(keys)[:n]


def planet_like(n: int, rng: np.random.Generator) -> np.ndarray:
    """C2: globally & locally normal — mixture of broad Gaussians (geo ids)."""
    k = 32
    centers = rng.uniform(0, 2**56, k)
    parts = [rng.normal(c, 2**50, int(n * 1.1) // k) for c in centers]
    keys = np.abs(np.concatenate(parts))
    return _sorted_unique(keys.astype(np.uint64))[:n]


def genome_like(n: int, rng: np.random.Generator) -> np.ndarray:
    """C3: globally normal, locally hard — dense loci clusters with tiny gaps.
    Key range matches real genome coordinates (< 2^38), so double-precision
    models resolve unit gaps exactly, as in the paper's GENOME dataset."""
    k = max(n // 2000, 8)
    centers = np.sort(rng.uniform(0, 2**38, k))
    per = int(n * 1.1) // k
    parts = [ (c + np.cumsum(rng.integers(1, 4, per))).astype(np.uint64)
              for c in centers ]
    return _sorted_unique(np.concatenate(parts))[:n]


def osm_like(n: int, rng: np.random.Generator) -> np.ndarray:
    """C4: globally hard — heavy-tailed (cell ids), huge empty stretches."""
    k = max(n // 4000, 8)
    centers = rng.uniform(0, 2**60, k)
    per = int(n * 1.5) // k
    parts = [ (c + np.abs(rng.standard_cauchy(per)) * rng.choice([1e3, 1e5, 1e7]))
              for c in centers ]
    keys = np.concatenate(parts)
    keys = keys[np.isfinite(keys) & (keys < 2**62)]
    return _sorted_unique(keys.astype(np.uint64))[:n]


DATASETS: dict[str, Callable[[int, np.random.Generator], np.ndarray]] = {
    "covid": covid_like,
    "planet": planet_like,
    "genome": genome_like,
    "osm": osm_like,
}


def make_dataset(name: str, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    req = n
    for _ in range(4):  # heavy-tailed generators can fall short: oversample
        keys = DATASETS[name](req, rng)
        if len(keys) >= n:
            return keys[:n]
        req = int(req * 1.6)
    assert len(keys) >= int(0.9 * n), f"{name}: got {len(keys)} < {n} keys"
    return keys


def payloads_for(keys: np.ndarray) -> np.ndarray:
    """The paper's payload: key + 1 (§5.1.2)."""
    return keys + np.uint64(1)


def shifting_hotspot_keys(n_ops: int, lo: int, hi: int, *,
                          window_frac: float = 0.05, zipf_a: float = 1.3,
                          sweeps: float = 1.0,
                          rng: "np.random.Generator | None" = None,
                          seed: int = 0) -> np.ndarray:
    """Insert keys for the shifting-hotspot drift pattern (DESIGN.md §12):
    op ``i`` draws a key zipf-distanced from a hotspot *center* that advances
    linearly from ``lo`` to ``hi`` (``sweeps`` full passes over the keyspace).

    The zipf weights are bounded to a window of ``window_frac`` of the
    keyspace (plain ``rng.zipf`` is unbounded): distance rank ``r`` in
    ``[1, W]`` has probability ``∝ 1/r^zipf_a``, sampled by inverse-CDF so
    the whole draw is vectorized and **deterministic per seed** — the
    property the workload tests pin down.  Returned keys are clipped to
    ``[lo, hi]`` and never collide with the u64-max sentinel.  The rank
    table is capped at ``2**22`` entries so sparse u64 keyspans (where
    ``span * window_frac`` alone would be billions of ranks) stay cheap —
    the window only ever shrinks, never widens."""
    assert hi > lo
    rng = np.random.default_rng(seed) if rng is None else rng
    n_ops = int(n_ops)
    span = hi - lo
    window = max(min(int(span * window_frac), 1 << 22), 2)
    # inverse-CDF zipf over the bounded window
    w = 1.0 / np.power(np.arange(1, window + 1, dtype=np.float64), zipf_a)
    cdf = np.cumsum(w) / np.sum(w)
    ranks = np.searchsorted(cdf, rng.random(n_ops), side="left")
    sign = rng.choice(np.array([-1, 1], dtype=np.int64), n_ops)
    # center advances over the keyspace: frac(i/n * sweeps) in [0, 1)
    phase = np.modf(np.arange(n_ops, dtype=np.float64) / max(n_ops, 1)
                    * float(sweeps))[0]
    centers = lo + (phase * span).astype(np.int64)
    out = centers + sign * ranks
    return np.clip(out, lo, hi).astype(np.uint64)


# --------------------------------------------------------------------- workloads


@dataclasses.dataclass
class WorkloadResult:
    name: str
    index: str
    dataset: str
    ops: int
    seconds: float
    reads_per_op: float
    writes_per_op: float
    storage_bytes: int
    p50_us: float
    p99_us: float
    lat_std_us: float
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def throughput(self) -> float:
        return self.ops / self.seconds if self.seconds else float("inf")

    @property
    def blocks_per_op(self) -> float:
        return self.reads_per_op + self.writes_per_op

    def row(self) -> dict:
        return {
            "workload": self.name, "index": self.index, "dataset": self.dataset,
            "ops": self.ops, "throughput": round(self.throughput, 1),
            "reads_per_op": round(self.reads_per_op, 3),
            "writes_per_op": round(self.writes_per_op, 3),
            "storage_mb": round(self.storage_bytes / 1e6, 2),
            "p50_us": round(self.p50_us, 1), "p99_us": round(self.p99_us, 1),
            "lat_std_us": round(self.lat_std_us, 1), **self.extra,
        }


def _run(index: OrderedIndex, name: str, dataset: str, ops: list, measure_lat: bool
         ) -> WorkloadResult:
    """Execute a list of (kind, key, payload) ops with I/O + latency capture."""
    index.reset_io()
    lats = np.zeros(len(ops)) if measure_lat else None
    t0 = time.perf_counter()
    for i, (kind, key, payload) in enumerate(ops):
        if measure_lat:
            s = time.perf_counter_ns()
        if kind == 0:
            index.lookup(key)
        elif kind == 1:
            index.insert(key, payload)
        else:
            index.scan(key, 100)
        if measure_lat:
            lats[i] = (time.perf_counter_ns() - s) / 1e3
    dt = time.perf_counter() - t0
    io = index.io
    n = max(len(ops), 1)
    p50 = float(np.percentile(lats, 50)) if measure_lat else 0.0
    p99 = float(np.percentile(lats, 99)) if measure_lat else 0.0
    std = float(np.std(lats)) if measure_lat else 0.0
    return WorkloadResult(name, index.name, dataset, len(ops), dt,
                          io.reads / n, io.writes / n, index.storage_bytes,
                          p50, p99, std)


def run_workload(index: OrderedIndex, workload: str, keys: np.ndarray,
                 dataset: str = "?", n_queries: int = 20_000, seed: int = 1,
                 measure_lat: bool = False) -> WorkloadResult:
    """Build the index per the workload's protocol (§5.1.3) and run it."""
    rng = np.random.default_rng(seed)
    pays = payloads_for(keys)
    n = len(keys)

    if workload in ("w1_lookup", "w2_scan"):
        index.bulkload(keys, pays)
        qk = rng.choice(keys, n_queries)
        kind = 0 if workload == "w1_lookup" else 2
        ops = [(kind, int(k), 0) for k in qk]
        return _run(index, workload, dataset, ops, measure_lat)

    if workload == "append_only":
        half = keys[: n // 2]
        index.bulkload(half, payloads_for(half))
        tail = keys[n // 2 :][:n_queries]
        ops = [(1, int(k), int(k) + 1) for k in tail]
        return _run(index, workload, dataset, ops, measure_lat)

    if workload == "shifting_hotspot":
        # drift pattern of "Are Updatable Learned Indexes Ready?" (PAPERS.md):
        # inserts concentrate in a zipf-weighted window whose center advances
        # over the whole keyspace, so every range gets its turn being hot
        half = keys[: n // 2]
        index.bulkload(half, payloads_for(half))
        qk = shifting_hotspot_keys(n_queries, int(keys[0]), int(keys[-1]),
                                   rng=rng)
        ops = [(1, int(k), int(k) + 1) for k in qk]
        return _run(index, workload, dataset, ops, measure_lat)

    # W3-W6: initial index on a random 50% sample; remaining keys are inserted
    # (scaled version of the paper's 10M init + 10M ops protocol).
    perm = rng.permutation(n)
    init = np.sort(keys[perm[: n // 2]])
    rest = keys[perm[n // 2 :]]
    index.bulkload(init, payloads_for(init))
    ratios = {"w3_write": 0.0, "w4_read_heavy": 0.9,
              "w5_balanced": 0.5, "w6_write_heavy": 0.1}
    read_ratio = ratios[workload]
    n_ops = min(n_queries, len(rest))
    ops = []
    inserted: list[int] = []
    wi = 0
    for i in range(n_ops):
        if rng.random() < read_ratio:
            # reads sample keys known to exist (paper §5.1.3)
            pool_init = int(rng.integers(0, len(init)))
            if inserted and rng.random() < 0.5:
                ops.append((0, inserted[int(rng.integers(0, len(inserted)))], 0))
            else:
                ops.append((0, int(init[pool_init]), 0))
        else:
            k = int(rest[wi % len(rest)])
            wi += 1
            inserted.append(k)
            ops.append((1, k, k + 1))
    return _run(index, workload, dataset, ops, measure_lat)


WORKLOADS = ["w1_lookup", "w2_scan", "w3_write", "w4_read_heavy",
             "w5_balanced", "w6_write_heavy", "append_only",
             "shifting_hotspot"]
