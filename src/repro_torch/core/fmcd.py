# Copied from src/repro/core/fmcd.py (the port keeps its own copy).
"""Fastest Minimum Conflict Degree (FMCD) linear-model fitting.

AULID adopts LIPP's FMCD algorithm (paper §3.2, §4.1) for the inner nodes:
given ``n`` sorted keys and a slot budget ``m``, fit a monotonic linear model
``slot(k) = a*k + b`` that minimises the *conflict degree* — the maximum
number of keys mapped to the same slot.

Observation used here (equivalent to LIPP's formulation): a linear model with
slope ``a`` achieves conflict degree <= D iff every window of D consecutive
keys spans at least one slot, i.e. ``a * (key[i+D] - key[i]) >= 1`` for all
``i``.  The model must also fit in the node: ``a * (key[-1] - key[0]) <= m-1``.
Hence the minimum feasible D is the smallest D whose minimum window gap
``g(D) = min_i(key[i+D] - key[i])`` satisfies ``g(D) >= span / (m - 1)``, and
the "fastest" slope is the largest one that still fits, ``a = (m-1)/span``
(clamped so no window overflows).  We binary-search D in O(n log n).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LinearModel:
    slope: float
    intercept: float

    def predict(self, keys: np.ndarray) -> np.ndarray:
        # float64 keeps 2^53 integer keys exact enough for slot prediction;
        # predictions are clipped by the caller to [0, fanout).
        return np.floor(self.slope * keys.astype(np.float64) + self.intercept)

    def predict_clipped(self, keys, fanout: int) -> np.ndarray:
        p = self.predict(np.atleast_1d(np.asarray(keys)))
        return np.clip(p, 0, fanout - 1).astype(np.int64)


def min_window_gap(keys: np.ndarray, d: int) -> float:
    """min_i (key[i+d] - key[i]) over a sorted key array."""
    if d >= len(keys):
        return float(keys[-1] - keys[0])
    return float(np.min(keys[d:] - keys[:-d]))


def conflict_degree(keys: np.ndarray, model: LinearModel, fanout: int) -> int:
    """Max number of keys mapped to one slot under ``model`` (paper Table 1)."""
    slots = model.predict_clipped(keys, fanout)
    _, counts = np.unique(slots, return_counts=True)
    return int(counts.max()) if counts.size else 0


def fmcd(keys: np.ndarray, fanout: int) -> tuple[LinearModel, int]:
    """Fit the FMCD linear model for ``keys`` into ``fanout`` slots.

    Returns (model, achieved_conflict_degree_bound).  Keys must be sorted and
    unique.  The model is monotonic (slope > 0), a property AULID's NULL-slot
    forward scan relies on (paper §4.2.1).
    """
    keys = np.asarray(keys)
    n = len(keys)
    assert fanout >= 2
    if n == 0:
        return LinearModel(1.0, 0.0), 0
    if n == 1:
        return LinearModel(1.0, float(fanout // 2) - float(keys[0])), 1
    kf = keys.astype(np.float64)
    span = float(kf[-1] - kf[0])
    if span <= 0:  # all-equal keys (callers handle duplicates separately)
        return LinearModel(1.0, float(fanout // 2) - kf[0]), n

    target_gap = span / (fanout - 1)
    # Binary search the smallest feasible conflict degree D in [1, n].
    lo, hi = 1, n
    while lo < hi:
        mid = (lo + hi) // 2
        if min_window_gap(kf, mid) >= target_gap:
            hi = mid
        else:
            lo = mid + 1
    d = lo
    # Fastest slope that still fits the span into the node.
    slope = (fanout - 1) / span
    intercept = -slope * kf[0]
    model = LinearModel(slope, intercept)
    return model, d


def dataset_conflict_degree(keys: np.ndarray, fanout: int | None = None) -> int:
    """Paper Table 1's per-dataset hardness proxy: conflict degree of the FMCD
    model at a root node sized like AULID's root (2x the key count)."""
    keys = np.asarray(keys)
    if fanout is None:
        fanout = max(64, 2 * len(keys))
    model, _ = fmcd(keys, fanout)
    return conflict_degree(keys, model, fanout)
