"""Mean ms a step in the device write path: the engine's ``_after_writes``
(the batch upload and K2 ``overlay_merge``), timed by the benchmark to a
synchronize; None where the window made no write."""
PHASE = "overlay_merge"


def read(trace):
    if not trace["phase_calls"].get(PHASE) or not trace["steps"]:
        return None
    return trace["phase_s"][PHASE] * 1e3 / trace["steps"]
