"""Serving substrate of the port: the mixed read/write index engines over
the device mirror (monolithic and range-sharded), and the
continuous-batching LM engine over the learned paged-KV cache."""
from .engine import Request, ServeEngine
from .index_engine import (IndexEngine, IndexRequest, IndexShard,
                           compaction_executor, pad_queries, scan_bucket)
from .kv_cache import LearnedPageTable, PagePool
from .scan_rows import ScanRows
from .sharded_engine import ShardedIndexEngine

__all__ = ["IndexEngine", "IndexRequest", "IndexShard",
           "compaction_executor", "pad_queries", "scan_bucket",
           "LearnedPageTable", "PagePool", "Request", "ScanRows",
           "ServeEngine", "ShardedIndexEngine"]
