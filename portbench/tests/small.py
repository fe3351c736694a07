"""Small forms of the benchmark's cells for the CPU tests.

A cell keeps its mix and its engine; its data set shrinks to ``KEYS`` keys
over a key range cut in the same proportion, so the keys lie as densely
as at full size (1,000 apart on average): the control's float32 keys then
collide as they do there.  A bulkload sample shrinks in the same
proportion.

``sharded_cell`` is no cell of ``BENCHMARK.json``: the same data set in 8
range shards of a ``ShardedIndexEngine`` under ``HOT_RANGE``, writes
skewed to one shard and scans across shard bounds (``chip_smoke.py``'s
sharded step), which the harness serves for a later cell of that kind.
"""
from __future__ import annotations

import copy
import sys
import time

from portbench import spec

if str(spec.ROOT / "src") not in sys.path:
    sys.path.insert(0, str(spec.ROOT / "src"))

KEYS = 20_000
HOT_RANGE = {
    "kind": "index_requests", "clients": 8720, "warmup_steps": 3,
    "window_steps_per_s": 5,
    "writes": {"count": 512, "insert_share": 0.6, "update_share": 0.3,
               "delete_share": 0.1, "insert_keys": "shard_range",
               "hot_shard": 4},
    "gets": {"count": 8192, "absent_share": 0.1},
    "scans": {"count": 16, "length": 100, "near_bound_share": 0.5,
              "near_bound_within": 50, "checked_per_step": 16}}


def small_cell(name: str, keys: int = KEYS) -> spec.Cell:
    c = spec.cell(spec.load(), name)
    ds = c.config["dataset"]
    span = (ds["hi"] - ds["lo"]) * keys // ds["keys"]
    if c.traffic.get("bulkload"):
        b = c.traffic["bulkload"]
        b["sample"] = b["sample"] * keys // ds["keys"]
    ds["keys"], ds["hi"] = keys, ds["lo"] + span
    return c


def sharded_cell(keys: int = KEYS) -> spec.Cell:
    c = small_cell("covid-200M.w1-lookup", keys)
    c.name = "covid-sharded.hot-range"
    c.config.update(engine="ShardedIndexEngine", shards=8)
    c.traffic_name, c.traffic = "hot-range", copy.deepcopy(HOT_RANGE)
    return c


def run_cell(c: spec.Cell, seed: int = 2**31 + 7, steps: int = 3,
             trace: bool = False) -> dict:
    """A short run of a small cell on the CPU (no look for a card)."""
    from portbench import index_serving
    return index_serving.run(c, seed, 1.0, trace, "cpu",
                             time.perf_counter(), steps=steps)


def run_small(name: str, seed: int = 2**31 + 7, steps: int = 3,
              trace: bool = False) -> dict:
    return run_cell(small_cell(name), seed, steps, trace)


def cells() -> list:
    return [w["name"] for w in spec.load()["workloads"]]
