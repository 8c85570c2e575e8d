"""Mean host-clock length of one batched launch (`serve._launch_batch`:
the class's padding, `ops.mwd_batched`, the crop, ending in a
synchronize), as the server's records give it (ms)."""


def read(rec):
    """The metric from a traced run's record, or None where it holds
    nothing to read."""
    launches = rec.get("launches")
    if not launches:
        return None
    return 1e3 * sum(r["launch_s"] for r in launches) / len(launches)
