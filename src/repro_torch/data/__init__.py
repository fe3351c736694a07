# Copied from src/repro/data/__init__.py (the port keeps its own copy).
"""Data pipeline: packed block store + learned sample index + sharded loader."""
from .store import PackedDocStore, synth_corpus
from .loader import ShardedLoader

__all__ = ["PackedDocStore", "ShardedLoader", "synth_corpus"]
