"""The card's idle share of the traced window, in %: 100 x (1 - the union
of every device operation's interval in the profiler's trace / the
window's wall time)."""


def read(trace):
    dev = trace.get("device")
    if not dev or dev["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
