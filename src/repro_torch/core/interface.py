# Copied from src/repro/core/interface.py (the port keeps its own copy).
"""Common interface for all on-disk indexes (AULID + the five baselines).

Every index operates exclusively through a :class:`~repro.core.blockdev.BlockDevice`
so the benchmark harness can compare "fetched blocks per query" (the paper's
central metric) across implementations with identical accounting.
"""
from __future__ import annotations

import abc
from typing import Iterable, Optional

import numpy as np

from .blockdev import BlockDevice, IOStats


class OrderedIndex(abc.ABC):
    """A single-threaded updatable ordered index over (uint64 key -> uint64 payload)."""

    name: str = "abstract"

    def __init__(self, dev: Optional[BlockDevice] = None, **_: object):
        self.dev = dev if dev is not None else BlockDevice()

    # -- core API (paper §4) ---------------------------------------------------
    @abc.abstractmethod
    def bulkload(self, keys: np.ndarray, payloads: np.ndarray) -> None:
        """Build the index from sorted keys (paper §4.1)."""

    @abc.abstractmethod
    def lookup(self, key: int) -> Optional[int]:
        """Point query: payload for ``key`` or None (paper §4.2.1)."""

    @abc.abstractmethod
    def scan(self, start_key: int, count: int) -> list[tuple[int, int]]:
        """Range query: first ``count`` pairs with key >= start_key (paper §4.2.2)."""

    @abc.abstractmethod
    def insert(self, key: int, payload: int) -> None:
        """Insert a key-payload pair (paper §4.3)."""

    def delete(self, key: int) -> bool:  # optional op (paper §4.5)
        raise NotImplementedError(f"{self.name} does not implement delete")

    def update(self, key: int, payload: int) -> bool:
        """In-place payload update (paper §4.5)."""
        raise NotImplementedError(f"{self.name} does not implement update")

    # -- accounting --------------------------------------------------------------
    @property
    def io(self) -> IOStats:
        return self.dev.stats

    @property
    def storage_bytes(self) -> int:
        return self.dev.storage_bytes

    def reset_io(self) -> None:
        self.dev.reset_stats()

    # -- bulk helpers used by the workload runner ---------------------------------
    def lookup_many(self, keys: Iterable[int]) -> list[Optional[int]]:
        return [self.lookup(int(k)) for k in keys]
