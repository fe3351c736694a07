"""Learned paged-KV page table — port of ``src/repro/serving/kv_cache.py``.

Decode-time KV pages are allocated from a global pool shared by all live
sequences.  The logical->physical translation is an AULID index over
``key = (seq_id << 20) | logical_page``: an allocation inserts one key, a
finished sequence deletes its keys, and translations are batched lookups
through the index's device mirror — K1 (``fused_lookup``) on the card, its
plain version on the CPU.

As in the reference, every allocation or free drops the mirror, and the
next ``translate_batch`` rebuilds it (``build_device_index``) and uploads
it; the uploaded tensors are kept until the next change.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.aulid import Aulid, AulidConfig
from ..core.blockdev import BlockDevice
from ..core.device_index import DeviceIndex, build_device_index
from ..core.keys import keys_to_tensor
from ..core.lookup import device_arrays, lookup_batch
from ..device import resolve

PAGE_BITS = 20  # up to 2^20 logical pages per sequence


def page_key(seq_id: int, logical_page: int) -> int:
    return (int(seq_id) << PAGE_BITS) | int(logical_page)


class PagePool:
    """Physical page allocator (free-list)."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self.free = list(range(n_pages - 1, -1, -1))
        self.used: set[int] = set()

    def alloc(self) -> int:
        if not self.free:
            raise RuntimeError("KV page pool exhausted")
        p = self.free.pop()
        self.used.add(p)
        return p

    def release(self, p: int) -> None:
        self.used.discard(p)
        self.free.append(p)

    @property
    def n_free(self) -> int:
        return len(self.free)


class LearnedPageTable:
    """AULID-backed logical->physical page map with a device mirror on
    ``device`` (``cuda:0`` unless the caller names another)."""

    def __init__(self, pool: PagePool, device=None):
        self.pool = pool
        self.device = resolve(device)
        self.index = Aulid(BlockDevice(), cfg=AulidConfig())
        self._bulk: list[tuple[int, int]] = []
        self._built = False
        self._mirror: Optional[DeviceIndex] = None
        self._arrs: Optional[dict] = None
        self._pages_of: dict[int, list[tuple[int, int]]] = {}

    def _ensure_built(self) -> None:
        if not self._built:
            if self._bulk:
                ks = np.array(sorted(k for k, _ in self._bulk), dtype=np.uint64)
                by = dict(self._bulk)
                ps = np.array([by[int(k)] for k in ks], dtype=np.uint64)
                self.index.bulkload(ks, ps)
            else:
                self.index.bulkload(np.array([0], np.uint64),
                                    np.array([0], np.uint64))
                # sentinel key 0 -> page 0 is never queried (seq ids >= 1)
            self._built = True
            self._mirror = None

    def alloc_page(self, seq_id: int, logical_page: int) -> int:
        """Allocate a physical page and index it. Returns the physical id."""
        phys = self.pool.alloc()
        key = page_key(seq_id, logical_page)
        if self._built:
            self.index.insert(key, phys)
        else:
            self._bulk.append((key, phys))
        self._pages_of.setdefault(seq_id, []).append((logical_page, phys))
        self._mirror = None
        return phys

    def free_seq(self, seq_id: int) -> int:
        """Release all pages of a finished sequence."""
        self._ensure_built()
        n = 0
        for lp, phys in self._pages_of.pop(seq_id, []):
            self.index.delete(page_key(seq_id, lp))
            self.pool.release(phys)
            n += 1
        self._mirror = None
        return n

    def translate(self, seq_id: int, logical_page: int) -> Optional[int]:
        self._ensure_built()
        return self.index.lookup(page_key(seq_id, logical_page))

    def mirror(self) -> DeviceIndex:
        """Device mirror snapshot (rebuilt lazily after mutations)."""
        self._ensure_built()
        if self._mirror is None:
            self._mirror = build_device_index(self.index)
            self._arrs = None
        return self._mirror

    def translate_batch(self, seq_ids: np.ndarray,
                        logical_pages: np.ndarray) -> torch.Tensor:
        """Batched translation through the device mirror: an int64 tensor
        on the table's device, the physical page of each key or -1 where
        the key is absent."""
        di = self.mirror()
        if self._arrs is None:
            self._arrs = device_arrays(di, self.device)
        keys = ((np.asarray(seq_ids).astype(np.uint64) << np.uint64(PAGE_BITS))
                | np.asarray(logical_pages).astype(np.uint64))
        pay, found, _ = lookup_batch(self._arrs,
                                     keys_to_tensor(keys, self.device),
                                     height=max(di.max_inner_height, 3))
        return torch.where(found, pay, -1)
