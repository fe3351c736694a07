"""99th percentile of every request's latency in the traced window, in ms:
from its ``submit`` to the end of the step that answered it (host clock)."""
import numpy as np


def read(trace):
    lat = trace.get("latency_s")
    if lat is None or not lat.size:
        return None
    return float(np.percentile(lat, 99)) * 1e3
