# Copied from src/repro/runtime/ft.py (the port keeps its own copy).
"""Fault-tolerance building blocks, unit-tested against a simulated cluster.

At 1000+ nodes the failure model is: (a) hard node loss (process gone),
(b) stragglers (10-100x step-time tail), (c) network partitions that look
like (a). The mechanisms here are the standard production responses:

* heartbeats with a missed-beat threshold -> declare failure;
* straggler detection against a rolling per-step deadline
  (k x median of recent step times) -> deadline-skip or evict;
* elastic re-mesh: drop the failed host's chips, shrink the 'data' axis to
  the largest divisor mesh, rescale per-device batch to keep the GLOBAL
  batch constant (the optimizer never sees the failure);
* checkpoint/restart as the backstop (driver.py).

Everything is deterministic under a seed so the tests can assert exact
recovery behavior.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class WorkerState:
    alive: bool = True
    last_beat: float = 0.0
    slow_factor: float = 1.0


class SimCluster:
    """A simulated pool of workers with failure/straggler injection."""

    def __init__(self, n_workers: int, seed: int = 0,
                 base_step_s: float = 1.0):
        self.n = n_workers
        self.rng = np.random.default_rng(seed)
        self.base = base_step_s
        self.workers = [WorkerState() for _ in range(n_workers)]
        self.clock = 0.0

    def inject_failure(self, rank: int) -> None:
        self.workers[rank].alive = False

    def inject_straggler(self, rank: int, factor: float = 20.0) -> None:
        self.workers[rank].slow_factor = factor

    def heal(self, rank: int) -> None:
        self.workers[rank] = WorkerState(last_beat=self.clock)

    def step_times(self) -> np.ndarray:
        """Per-worker wall time for one step (inf if dead)."""
        noise = self.rng.lognormal(0.0, 0.05, self.n)
        t = np.array([self.base * w.slow_factor if w.alive else np.inf
                      for w in self.workers]) * noise
        self.clock += float(np.nanmax(np.where(np.isinf(t), np.nan, t)))
        for w in self.workers:
            if w.alive:
                w.last_beat = self.clock
        return t

    def alive_ranks(self) -> list[int]:
        return [i for i, w in enumerate(self.workers) if w.alive]


class StragglerDetector:
    """Rolling-median deadline detector (k x median over a window)."""

    def __init__(self, k: float = 3.0, window: int = 20):
        self.k = k
        self.window = window
        self.history: list[float] = []

    def observe(self, step_times: np.ndarray) -> list[int]:
        """Returns ranks exceeding the deadline this step (incl. dead)."""
        finite = step_times[np.isfinite(step_times)]
        if finite.size:
            self.history.append(float(np.median(finite)))
            self.history = self.history[-self.window:]
        deadline = self.k * float(np.median(self.history)) if self.history else np.inf
        return [int(i) for i in np.nonzero(~(step_times <= deadline))[0]]


@dataclasses.dataclass
class ElasticPlan:
    old_dp: int
    new_dp: int
    per_device_batch: int
    dropped_ranks: list[int]

    @property
    def changed(self) -> bool:
        return self.new_dp != self.old_dp


def plan_elastic_remesh(global_batch: int, dp_size: int,
                        failed_ranks: list[int],
                        model_parallel: int = 1) -> Optional[ElasticPlan]:
    """Shrink the data axis to the largest feasible size after failures.

    The model axis cannot shrink without re-sharding weights layouts, so a
    failure inside a model-parallel group drops the whole group from the
    data axis (standard practice). Returns None if no feasible mesh exists
    or the global batch is no longer divisible."""
    lost_groups = len(set(failed_ranks))
    new_dp = dp_size - lost_groups
    while new_dp > 0 and global_batch % new_dp != 0:
        new_dp -= 1
    if new_dp <= 0:
        return None
    return ElasticPlan(dp_size, new_dp, global_batch // new_dp,
                       sorted(set(failed_ranks)))
