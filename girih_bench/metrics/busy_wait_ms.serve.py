"""Mean time a served request waited before its batch window opened, from
its due time, while the server worked on other batches: the ``busy_s`` of
the ``girih.serve.request`` spans (ms)."""


def read(rec):
    """The metric from a traced run's record, or None where it holds
    nothing to read."""
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    waits = [s.attrs["busy_s"] for s in trace.spans("girih.serve.request")]
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
