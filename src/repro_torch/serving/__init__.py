"""Serving substrate of the port: the monolithic mixed read/write index
engine over the device mirror, and the continuous-batching LM engine over
the learned paged-KV cache."""
from .engine import Request, ServeEngine
from .index_engine import (IndexEngine, IndexRequest, IndexShard,
                           compaction_executor, pad_queries, scan_bucket)
from .kv_cache import LearnedPageTable, PagePool

__all__ = ["IndexEngine", "IndexRequest", "IndexShard",
           "compaction_executor", "pad_queries", "scan_bucket",
           "LearnedPageTable", "PagePool", "Request", "ServeEngine"]
