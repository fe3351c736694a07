# Copied from src/repro/data/store.py (the port keeps its own copy).
"""Packed document store with an AULID sample index.

Variable-length token documents are packed back-to-back into fixed 4 KB
blocks (a document may span blocks). Random access for shuffled training
goes through an AULID index ``doc_id -> packed offset``: one learned-index
lookup (~2-3 block fetches, Fig 5) replaces a scan or a dense offset table.
This is integration #2 of DESIGN.md §3 — the paper's index as the data
pipeline's random-access substrate, with the same BlockDevice I/O accounting
as the standalone benchmarks.
"""
from __future__ import annotations

import numpy as np

from ..core.aulid import Aulid, AulidConfig
from ..core.blockdev import BlockDevice

TOKENS_PER_BLOCK = 512  # one token per u64 device word; 4 KB blocks


def synth_corpus(n_docs: int, vocab: int, seed: int = 0,
                 mean_len: int = 512) -> list[np.ndarray]:
    """Zipf-ish synthetic token documents of varying length."""
    rng = np.random.default_rng(seed)
    lens = np.maximum(8, rng.geometric(1.0 / mean_len, n_docs)).astype(np.int64)
    a = rng.zipf(1.3, size=int(lens.sum())) % vocab
    docs, off = [], 0
    for ln in lens:
        docs.append(a[off: off + ln].astype(np.int32))
        off += ln
    return docs


class PackedDocStore:
    """Token blocks on a BlockDevice + AULID(doc_id -> global token offset)."""

    def __init__(self, block_tokens: int = TOKENS_PER_BLOCK):
        self.block_tokens = block_tokens
        self.dev = BlockDevice(block_bytes=block_tokens * 8)
        self.index = Aulid(BlockDevice(), cfg=AulidConfig())
        self._blocks: list[int] = []      # device block ids in order
        self._tokens = np.zeros(0, np.int32)
        self.n_docs = 0
        self._lengths: dict[int, int] = {}

    def build(self, docs: list[np.ndarray]) -> None:
        offsets = np.zeros(len(docs), np.uint64)
        pos = 0
        for i, d in enumerate(docs):
            offsets[i] = pos
            self._lengths[i] = len(d)
            pos += len(d)
        self._tokens = np.concatenate(docs).astype(np.int32)
        nblocks = -(-len(self._tokens) // self.block_tokens)
        for b in range(nblocks):
            bid = self.dev.alloc()
            lo = b * self.block_tokens
            hi = min((b + 1) * self.block_tokens, len(self._tokens))
            words = self.dev.write(bid)
            chunk = self._tokens[lo:hi].astype(np.uint64)
            words[: len(chunk)] = chunk
            self._blocks.append(bid)
        # learned index: doc_id -> starting token offset
        ids = np.arange(len(docs), dtype=np.uint64)
        self.index.bulkload(ids, offsets)
        self.n_docs = len(docs)

    def append(self, doc: np.ndarray) -> int:
        """Streaming ingestion: extend blocks, insert into the index."""
        doc_id = self.n_docs
        off = len(self._tokens)
        self._tokens = np.concatenate([self._tokens, doc.astype(np.int32)])
        while len(self._blocks) * self.block_tokens < len(self._tokens):
            self._blocks.append(self.dev.alloc())
            self.dev.write(self._blocks[-1])
        self.index.insert(doc_id, off)
        self._lengths[doc_id] = len(doc)
        self.n_docs += 1
        return doc_id

    def get(self, doc_id: int) -> np.ndarray:
        """Fetch one document: 1 index lookup + ceil(len/bt) block reads."""
        off = self.index.lookup(doc_id)
        assert off is not None, f"unknown doc {doc_id}"
        ln = self._lengths[doc_id]
        b0, b1 = off // self.block_tokens, (off + ln - 1) // self.block_tokens
        for b in range(b0, b1 + 1):
            self.dev.read(self._blocks[b])
        return self._tokens[off: off + ln]

    @property
    def io_per_sample(self) -> float:
        tot = self.dev.stats.reads + self.index.dev.stats.reads
        return tot
