"""K2 ``overlay_merge``'s share of its roofline over the window, in %: the
frozen live-entry bound (``bounds.k2_live_bytes``) summed over every merge,
over the merges' device time (a rank and a scatter launch each) from the
profiler; scaled as ``k1_roofline_pct`` where events are missing."""


def read(trace):
    dev = trace.get("device")
    if not dev or not trace.get("k2_bound_s") or not dev["k2_events"] \
            or dev["k2_device_s"] <= 0:
        return None
    per_merge = dev["k2_device_s"] / (dev["k2_events"] / 2)
    return 100.0 * trace["k2_bound_s"] / (per_merge * trace["k2_merges"])
