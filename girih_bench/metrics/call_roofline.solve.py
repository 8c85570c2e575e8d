"""The whole call's share of its least possible time: the frozen bound of
one call times the calls, over the traced window's wall time (%)."""


def read(rec):
    """The metric from a traced run's record, or None where it holds
    nothing to read."""
    if not rec.get("calls"):
        return None
    return 100.0 * rec["bound_s"] * rec["calls"] / rec["window_s"]
