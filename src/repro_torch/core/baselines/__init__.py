# Copied from src/repro/core/baselines/__init__.py (the port keeps its own copy).
"""On-disk implementations of the paper's five baselines (§5.1.1).

All share the BlockDevice accounting of AULID so "fetched blocks per query"
is comparable. They reproduce each index's on-disk *I/O behaviour* — block
layout, fetch pattern, SMO write amplification — which is what the paper
measures; in-memory micro-optimizations that do not change block counts are
simplified (documented per module).
"""
from .btree import BPlusTree
from .pgm import PGMIndex
from .fiting import FITingTree
from .alex import AlexIndex
from .lipp import LippIndex

ALL_BASELINES = {
    "btree": BPlusTree,
    "pgm": PGMIndex,
    "fiting": FITingTree,
    "alex": AlexIndex,
    "lipp": LippIndex,
}

__all__ = ["BPlusTree", "PGMIndex", "FITingTree", "AlexIndex", "LippIndex",
           "ALL_BASELINES"]
