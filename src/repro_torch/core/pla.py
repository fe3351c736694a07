# Copied from src/repro/core/pla.py (the port keeps its own copy).
"""Error-bounded piecewise linear approximation (shared by PGM & FITing-tree).

The shrinking-cone / slope-corridor streaming algorithm (O'Rourke '81 [24],
used by FITing-tree [8] and equivalent in spirit to PGM's optimal one-pass
partitioning [7]): anchor a segment at its first point and keep the feasible
slope interval [lo, hi] such that every covered point's rank is predicted
within +-eps; start a new segment when the interval empties.

The paper replaces FITing-tree's greedy partitioning with exactly this
streaming algorithm (§5.1.1), so both baselines share it here.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Segment:
    first_key: int
    slope: float          # rank = slope * (key - first_key)
    start_rank: int       # rank of first_key in the underlying array
    n: int                # number of keys covered

    def predict(self, key: int) -> int:
        """Predicted rank offset within the segment (clipped by callers)."""
        return int(self.slope * (float(key) - float(self.first_key)))


def build_segments(keys: np.ndarray, eps: int) -> list[Segment]:
    """One pass over sorted keys; O(n)."""
    n = len(keys)
    segs: list[Segment] = []
    if n == 0:
        return segs
    kf = keys.astype(np.float64)
    i0 = 0
    lo, hi = 0.0, np.inf
    for i in range(1, n + 1):
        if i == n:
            break
        dx = kf[i] - kf[i0]
        r = i - i0
        if dx <= 0:  # duplicate key: cannot split ranks; force corridor on
            continue
        new_lo = max(lo, (r - eps) / dx)
        new_hi = min(hi, (r + eps) / dx)
        if new_lo > new_hi:  # corridor empty: close the segment at i-1
            slope = (lo + min(hi, lo + 2 * eps)) / 2 if np.isfinite(hi) else lo
            segs.append(Segment(int(keys[i0]), float(slope), i0, i - i0))
            i0 = i
            lo, hi = 0.0, np.inf
        else:
            lo, hi = new_lo, new_hi
    slope = (lo + min(hi, lo + 2 * eps)) / 2 if np.isfinite(hi) else max(lo, 0.0)
    segs.append(Segment(int(keys[i0]), float(slope), i0, n - i0))
    return segs
