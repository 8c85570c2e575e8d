"""Share of the window the server slept with nothing queued, waiting for
the next request to come due: the ``girih.serve.idle`` spans' host-clock
length, summed, over the window (%)."""


def read(rec):
    """The metric from a traced run's record, or None where it holds
    nothing to read."""
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    if not rec.get("window_s") or not trace.spans("girih.serve.launch"):
        return None
    idle = sum(s.seconds for s in trace.spans("girih.serve.idle"))
    return 100.0 * idle / rec["window_s"]
