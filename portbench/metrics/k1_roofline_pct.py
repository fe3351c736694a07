"""K1 ``fused_lookup``'s share of its roofline over the window, in %: the
frozen byte bound (``bounds.k1_bytes`` at ``HBM_BYTES_PER_S``) summed over
every launch, over the launches' device time from the profiler.  Where the
trace holds fewer K1 events than launches were made, the device time is
the events' mean times the launches."""


def read(trace):
    dev = trace.get("device")
    if not dev or not trace.get("k1_bound_s") or not dev["k1_events"] \
            or dev["k1_device_s"] <= 0:
        return None
    per = dev["k1_device_s"] / dev["k1_events"]
    return 100.0 * trace["k1_bound_s"] / (per * trace["k1_launches"])
