"""AULID core of the port: the copied host index and mirror builder, the key
codec, and the batched device read/write path (``lookup``)."""
from .aulid import Aulid, AulidConfig, JournalEntry
from .blockdev import BlockDevice, IOStats
from .delta_overlay import DeltaOverlay
from .fmcd import LinearModel, fmcd, conflict_degree, dataset_conflict_degree
from .interface import OrderedIndex
from .partition import RangePartition, partition_bulkload

__all__ = ["Aulid", "AulidConfig", "BlockDevice", "DeltaOverlay", "IOStats",
           "JournalEntry", "LinearModel", "fmcd", "conflict_degree",
           "dataset_conflict_degree", "OrderedIndex", "RangePartition",
           "partition_bulkload"]
