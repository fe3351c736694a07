"""The yardstick's byte counts and peaks, frozen here from the program
(``repro_torch.kernels.fused_lookup.ops`` and ``chip_smoke.py``) so that
no later change to the program moves them.

A kernel's roofline share is the least time its bytes take at the card's
HBM peak over the kernel's device time; the bytes are what the launch must
move on its data, each input read and each output written once.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak (NVIDIA data sheet)


def k1_walks(last_leaf_min: np.ndarray, root: np.ndarray,
             bounds: np.ndarray, q: np.ndarray) -> int:
    """Queries of ``q`` that enter the inner tree of their shard: a root is
    present and the key lies below the shard's last-leaf minimum; the
    others read no node and no slot.  All biased int64 on the host: the
    mirror's per-shard ``last_leaf_min`` and ``meta[:, 0]`` (the root) and
    its boundary table (empty for one shard)."""
    sid = (bounds[None, :] < q[:, None]).sum(1) if bounds.size else \
        np.zeros(q.shape[0], np.int64)
    return int(((q < last_leaf_min[sid]) & (root[sid] >= 0)).sum())


def k1_bytes(Q: int, walks: int, rows: int, cap: int, overlay: bool,
             sharded: bool = False, n_bounds: int = 0) -> int:
    """Bytes a K1 launch must move on its data: queries in; payload, found,
    leaf row (and shard id) out; each of the ``rows`` distinct leaf rows'
    ``cap`` keys once and a payload word a query; one slot record
    (next_occ, key, tag, pointer: 20 bytes) for each of the ``walks``
    queries that enter the inner tree; with an overlay, one overlay key a
    query; the boundary table."""
    return Q * (8 + (17 if sharded else 13) + 8 + (8 if overlay else 0)) \
        + walks * 20 + rows * cap * 8 + n_bounds * 8


def k2_live_bytes(live: int, batch: int, merged: int, pad: int) -> int:
    """The bytes a K2 merge into a target must move: the served pack's
    live entries in, the batch's in, the merged ones out and the target's
    slots past them that held entries (24 bytes each: key, payload,
    tombstone)."""
    return 24 * (live + batch + merged + pad)


def bound_s(nbytes: int) -> float:
    """The time to move ``nbytes`` at the card's HBM peak, in seconds."""
    return nbytes / HBM_BYTES_PER_S
