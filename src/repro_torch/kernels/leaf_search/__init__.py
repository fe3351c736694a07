from .ops import leaf_search, leaf_search_plain

__all__ = ["leaf_search", "leaf_search_plain"]
