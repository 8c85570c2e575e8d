"""Padding waste: the server's records' extra cells over real cells,
weighted by batch size (%)."""


def read(rec):
    """The metric from a traced run's record, or None where it holds
    nothing to read."""
    launches = rec.get("launches")
    if not launches:
        return None
    size = sum(r["size"] for r in launches)
    return 100.0 * sum(r["waste"] * r["size"] for r in launches) / size
