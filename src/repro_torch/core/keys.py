"""u64 key codec of the port.

PyTorch has no ordered compare, ``searchsorted`` or shift for
``torch.uint64``, so:

* a u64 key travels as an ``int64`` with the sign bit flipped
  (``k ^ 2**63``): signed order on the biased value is unsigned order on
  the key, and the ``UINT64_MAX`` padding becomes ``INT64_MAX``;
* a payload travels as an ``int64`` holding the same 64 bits;
* the float64 value of a key (the FMCD slot prediction's input) is rebuilt
  as ``hi * 2**32 + lo``: one rounding, equal to numpy's u64 -> f64 cast.
"""
from __future__ import annotations

import numpy as np
import torch

SIGN = np.uint64(1 << 63)
UINT64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
# UINT64_MAX in the biased representation: the padding of every key pool
BIASED_MAX = (1 << 63) - 1
_INT64_MIN = -(1 << 63)


def bias_np(keys) -> np.ndarray:
    """u64 keys -> biased int64 (order-preserving), as a new array."""
    return (np.asarray(keys, dtype=np.uint64) ^ SIGN).view(np.int64)


def unbias_np(biased) -> np.ndarray:
    """Biased int64 -> u64 keys, as a new array."""
    return np.ascontiguousarray(biased, dtype=np.int64).view(np.uint64) ^ SIGN


def keys_to_tensor(keys, device) -> torch.Tensor:
    """u64 keys (any array-like) -> biased int64 tensor on ``device``."""
    return torch.from_numpy(bias_np(keys)).to(device)


def keys_from_tensor(t: torch.Tensor) -> np.ndarray:
    """Biased int64 tensor -> u64 numpy keys."""
    return unbias_np(t.cpu().numpy())


def bits_from_tensor(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> u64 numpy array of the same bits."""
    return t.cpu().numpy().view(np.uint64)


def key_f64(biased: torch.Tensor) -> torch.Tensor:
    """Exact-rounding float64 value of biased keys: ``hi * 2**32 + lo`` on
    the un-biased bits (hi * 2**32 is exact, the add rounds once)."""
    u = biased ^ _INT64_MIN
    hi = (u >> 32) & 0xFFFFFFFF
    lo = u & 0xFFFFFFFF
    return hi.to(torch.float64) * 4294967296.0 + lo.to(torch.float64)
