"""Mean time a served request waited in its batch window, from the later
of its due time and the window's opening to the batch's close: the
``window_s`` of the ``girih.serve.request`` spans (ms)."""


def read(rec):
    """The metric from a traced run's record, or None where it holds
    nothing to read."""
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    waits = [s.attrs["window_s"] for s in trace.spans("girih.serve.request")]
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
