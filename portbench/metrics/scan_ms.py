"""Mean ms a step in the scans: the engine's ``_serve_scans`` (K1 for the
start leaf, the leaf-chain walk, the overlay merge, the rows), timed by
the benchmark to a synchronize; None where the window served no scan."""
PHASE = "scans"


def read(trace):
    if not trace["phase_calls"].get(PHASE) or not trace["steps"]:
        return None
    return trace["phase_s"][PHASE] * 1e3 / trace["steps"]
