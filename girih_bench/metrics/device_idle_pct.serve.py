"""Share of the traced window in which the device ran nothing: one less
the union of device-busy intervals over the window (%)."""


def read(rec):
    """The metric from a traced run's record, or None where it holds
    nothing to read."""
    tr = rec["trace"]
    if not tr["device_ops"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
