from .ops import (KIND_CONT, KIND_END, SPB, ProbeIndex, inner_probe_lookup,
                  probe_level, probe_level_plain)

__all__ = ["KIND_CONT", "KIND_END", "SPB", "ProbeIndex", "inner_probe_lookup",
           "probe_level", "probe_level_plain"]
