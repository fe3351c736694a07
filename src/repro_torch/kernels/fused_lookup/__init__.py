from .ops import fused_lookup, lookup_plain

__all__ = ["fused_lookup", "lookup_plain"]
