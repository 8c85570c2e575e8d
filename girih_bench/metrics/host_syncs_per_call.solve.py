"""Host-blocking waits on the device an `ops.mwd` call: the program's
``syncs`` counter as the traced window saw it (each count there is a
``girih.sync`` span), those inside ``girih.mwd``, over the calls."""


def read(rec):
    """The metric from a traced run's record, or None where it holds
    nothing to read."""
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    if not rec.get("calls") or not trace.spans("girih.mwd"):
        return None
    syncs = [s for s in trace.spans("girih.sync") if s.under("girih.mwd")]
    return len(syncs) / rec["calls"]
