"""Serving substrate of the port: the monolithic mixed read/write index
engine over the device mirror."""
from .index_engine import (IndexEngine, IndexRequest, IndexShard,
                           compaction_executor, pad_queries, scan_bucket)

__all__ = ["IndexEngine", "IndexRequest", "IndexShard",
           "compaction_executor", "pad_queries", "scan_bucket"]
