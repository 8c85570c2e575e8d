"""Mean wait of a served request from its due time to the start of the
launch that served it (the launch's end less its host-clock length) (ms)."""


def read(rec):
    """The metric from a traced run's record, or None where it holds
    nothing to read."""
    waits = rec.get("waits")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
