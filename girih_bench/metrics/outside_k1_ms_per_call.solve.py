"""Device time a call spends outside K1 (frame sync, the two parity pads,
the crop): every device operation in the traced window other than
``mwd_row_kernel``, summed, over the calls (ms)."""

K1 = "mwd_row_kernel"


def read(rec):
    """The metric from a traced run's record, or None where it holds
    nothing to read."""
    ops = rec["trace"]["device_ops"]
    if not ops or not rec.get("calls"):
        return None
    other_s = sum(b - a for name, a, b in ops if K1 not in name)
    return 1e3 * other_s / rec["calls"]
