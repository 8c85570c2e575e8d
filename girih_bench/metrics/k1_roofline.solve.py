"""K1's share of its roofline: the frozen bound of one call times the
calls, over the summed device time of K1 (``mwd_row_kernel``) (%)."""

K1 = "mwd_row_kernel"


def read(rec):
    """The metric from a traced run's record, or None where it holds
    nothing to read."""
    k1_s = sum(b - a for name, a, b in rec["trace"]["device_ops"]
               if K1 in name)
    if not k1_s or not rec.get("calls"):
        return None
    return 100.0 * rec["bound_s"] * rec["calls"] / k1_s
