# Copied from src/repro/core/blockdev.py (the port keeps its own copy).
"""Simulated block device with I/O accounting.

The paper's dominant cost is block I/O: every index here (AULID and the five
baselines) routes reads/writes through a :class:`BlockDevice` so that
"fetched blocks per query" — the paper's hardware-independent explanatory
metric (Figs 1c, 5, 6) — is measured identically for all of them.

A block is ``block_bytes`` of storage, modelled as a ``block_bytes // 8``-slot
``uint64`` numpy array (the paper uses 4 KB blocks = 256 key-payload pairs of
16 bytes, i.e. 512 u64 words).  On the TPU adaptation the same 4 KB unit is
one HBM block tile (see DESIGN.md §2); this module is the host-side twin used
by benchmarks and the structure-mutation paths.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

WORD_BYTES = 8


@dataclasses.dataclass
class IOStats:
    reads: int = 0
    writes: int = 0
    allocs: int = 0
    frees: int = 0

    def snapshot(self) -> "IOStats":
        return IOStats(self.reads, self.writes, self.allocs, self.frees)

    def delta(self, other: "IOStats") -> "IOStats":
        """Stats accumulated since ``other`` (an earlier snapshot)."""
        return IOStats(
            self.reads - other.reads,
            self.writes - other.writes,
            self.allocs - other.allocs,
            self.frees - other.frees,
        )

    @property
    def total(self) -> int:
        return self.reads + self.writes


class BlockDevice:
    """Growable array of fixed-size blocks with read/write accounting.

    ``read``/``write`` count one I/O each regardless of how much of the block
    is touched — matching disk semantics where a 4 KB block is the minimum
    transfer unit.  ``read_word``/``write_words`` are conveniences that still
    count a whole block I/O.
    """

    def __init__(self, block_bytes: int = 4096, initial_blocks: int = 64):
        assert block_bytes % WORD_BYTES == 0
        self.block_bytes = block_bytes
        self.words_per_block = block_bytes // WORD_BYTES
        self._store = np.zeros((initial_blocks, self.words_per_block), dtype=np.uint64)
        self._allocated = np.zeros(initial_blocks, dtype=bool)
        self._free_list: list[int] = list(range(initial_blocks - 1, -1, -1))
        self.stats = IOStats()
        # Per-call-site tallies, keyed by a caller-supplied tag. Used by the
        # latency-breakdown benchmarks (paper Figs 13-15).
        self.tagged: dict[str, IOStats] = {}
        self._tag: Optional[str] = None

    # -- tag scoping ---------------------------------------------------------
    def set_tag(self, tag: Optional[str]) -> None:
        self._tag = tag
        if tag is not None and tag not in self.tagged:
            self.tagged[tag] = IOStats()

    def _count(self, field: str, n: int = 1) -> None:
        setattr(self.stats, field, getattr(self.stats, field) + n)
        if self._tag is not None:
            t = self.tagged[self._tag]
            setattr(t, field, getattr(t, field) + n)

    # -- allocation ----------------------------------------------------------
    def _grow(self) -> None:
        old = self._store.shape[0]
        new = old * 2
        store = np.zeros((new, self.words_per_block), dtype=np.uint64)
        store[:old] = self._store
        self._store = store
        allocated = np.zeros(new, dtype=bool)
        allocated[:old] = self._allocated
        self._allocated = allocated
        self._free_list.extend(range(new - 1, old - 1, -1))

    def alloc(self) -> int:
        if not self._free_list:
            self._grow()
        bid = self._free_list.pop()
        self._allocated[bid] = True
        self._count("allocs")
        return bid

    def free(self, block_id: int) -> None:
        assert self._allocated[block_id], f"double free of block {block_id}"
        self._allocated[block_id] = False
        self._store[block_id] = 0
        self._free_list.append(block_id)
        self._count("frees")

    # -- I/O -----------------------------------------------------------------
    def read(self, block_id: int) -> np.ndarray:
        assert self._allocated[block_id], f"read of unallocated block {block_id}"
        self._count("reads")
        return self._store[block_id]

    def write(self, block_id: int, words: Optional[np.ndarray] = None) -> np.ndarray:
        """Count a block write; optionally replace the block's contents.

        Returns the (mutable) backing array so callers may update it in place
        after the accounting — the paper's indexes always rewrite whole blocks.
        """
        assert self._allocated[block_id], f"write of unallocated block {block_id}"
        self._count("writes")
        if words is not None:
            w = np.asarray(words, dtype=np.uint64)
            assert w.size <= self.words_per_block
            self._store[block_id, : w.size] = w
        return self._store[block_id]

    def peek(self, block_id: int) -> np.ndarray:
        """Access without accounting — for assertions/mirror builds only."""
        return self._store[block_id]

    # -- introspection --------------------------------------------------------
    @property
    def allocated_blocks(self) -> int:
        return int(self._allocated.sum())

    @property
    def storage_bytes(self) -> int:
        """On-'disk' footprint = allocated blocks × block size (paper Fig 8/9)."""
        return self.allocated_blocks * self.block_bytes

    def reset_stats(self) -> None:
        self.stats = IOStats()
        self.tagged.clear()
