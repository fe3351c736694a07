from .ops import overlay_probe, overlay_probe_plain

__all__ = ["overlay_probe", "overlay_probe_plain"]
