"""Requests a batched launch: served requests over launches in the window."""


def read(rec):
    """The metric from a traced run's record, or None where it holds
    nothing to read."""
    sizes = [r["size"] for r in rec.get("launches", ())]
    if not sizes:
        return None
    return sum(sizes) / len(sizes)
