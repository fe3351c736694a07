"""Mean ms a step in the read path: the engine's ``_serve_gets`` (the
queries' upload, K1 ``fused_lookup`` or its shard route, the results),
timed by the benchmark to a synchronize; None where the window served no
get."""
PHASE = "gets"


def read(trace):
    if not trace["phase_calls"].get(PHASE) or not trace["steps"]:
        return None
    return trace["phase_s"][PHASE] * 1e3 / trace["steps"]
