"""K1 launches that ran a star instance (the op's taps compiled in) over
all K1 launches, from the program's counters ``k1.star_launches`` and
``k1.launches``. They count over the process's life: the set-up's calls
run the window's op at the window's plan. A program without the star
counter reads nothing."""


def read(rec):
    """The metric from a traced run's record, or None where it holds
    nothing to read."""
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    counts = trace.counts()
    launches = counts.get("k1.launches", (0, 0.0))[0]
    if not rec.get("calls") or "k1.star_launches" not in counts \
            or not launches:
        return None
    return counts["k1.star_launches"][0] / launches
