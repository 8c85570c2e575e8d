"""K1 launches a call, from the program's launch counter
(`stencil_mwd.LAUNCHES`): one a diamond row of the schedule."""


def read(rec):
    """The metric from a traced run's record, or None where it holds
    nothing to read."""
    if not rec.get("calls"):
        return None
    return rec["k1_launches"] / rec["calls"]
