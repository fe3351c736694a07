from .ops import merge_overlay_pack_torch, overlay_merge

__all__ = ["merge_overlay_pack_torch", "overlay_merge"]
