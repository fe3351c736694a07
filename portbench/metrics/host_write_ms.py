"""Mean ms a step in the host index writes: the engine's ``_apply_write``
calls (``IndexShard.apply_write`` into ``Aulid`` and the
``DeltaOverlay``), timed by the benchmark around each call; None where the
window made no write."""
PHASE = "host_writes"


def read(trace):
    if not trace["phase_calls"].get(PHASE) or not trace["steps"]:
        return None
    return trace["phase_s"][PHASE] * 1e3 / trace["steps"]
