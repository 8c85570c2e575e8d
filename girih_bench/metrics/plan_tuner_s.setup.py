"""Seconds the process spent in the plan tuner (the registry's
model-scored fallback and plan translation): the program's ``plan.tuner``
counter at the end of the run, set-up included (s)."""


def read(rec):
    """The metric from a traced run's record, or None where it holds
    nothing to read."""
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    return trace.counts().get("plan.tuner", (0, 0.0))[1]
