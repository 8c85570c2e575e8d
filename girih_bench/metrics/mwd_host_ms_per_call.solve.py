"""Host time an `ops.mwd` call takes besides waiting on the device: the
``girih.mwd`` spans' host-clock length less their ``girih.sync`` spans,
summed, over the calls (ms)."""


def read(rec):
    """The metric from a traced run's record, or None where it holds
    nothing to read."""
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    calls = trace.spans("girih.mwd")
    if not rec.get("calls") or not calls:
        return None
    waits = sum(s.seconds for s in trace.spans("girih.sync")
                if s.under("girih.mwd"))
    return 1e3 * (sum(s.seconds for s in calls) - waits) / rec["calls"]
