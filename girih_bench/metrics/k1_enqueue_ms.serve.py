"""Mean host time from a batched launch's start to K1's rows being
enqueued: from each ``girih.serve.launch`` span's start to the end of the
first ``girih.mwd.launch`` span inside it (plan, padding, frame sync, pads,
tables, launcher) (ms)."""


def read(rec):
    """The metric from a traced run's record, or None where it holds
    nothing to read."""
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    first = {}
    for s in trace.spans("girih.mwd.launch"):
        launch = s.under("girih.serve.launch")
        if launch is not None and id(launch) not in first:
            first[id(launch)] = (s.end - launch.start) / 1e9
    if not first:
        return None
    return 1e3 * sum(first.values()) / len(first)
