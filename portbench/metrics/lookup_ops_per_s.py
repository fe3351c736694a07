"""The traced window's requests over its wall time, in ops/s: the rate of
a cell whose untraced rate is too unsteady on the host to be held end to
end.  The profiler and the phase timers slow the window, so it reads
below that cell's untraced rate; None without a traced window."""


def read(trace):
    dev = trace.get("device")
    if not dev or dev["window_s"] <= 0 or not trace["requests"]:
        return None
    return trace["requests"] / dev["window_s"]
