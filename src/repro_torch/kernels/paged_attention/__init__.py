from .ops import paged_attention, paged_attention_plain

__all__ = ["paged_attention", "paged_attention_plain"]
