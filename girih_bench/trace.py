"""The traced window: `torch.profiler` around it, reduced to a record.

`profiled` runs the window under the profiler (CPU and CUDA activities)
inside a ``girih.window`` span, and `reduce` turns the events into what the
per-layer readers and the result's ``device`` and ``breakdown`` take:

* ``window_s``: the span's length on the host;
* ``device_ops``: every device operation (kernel, copy, fill) inside it,
  as ``(name, start_s, end_s)`` from the span's start;
* ``busy_s``: the union of their intervals, so overlapping operations
  count once;
* ``top_ops``: the ten device operations that took most time, summed by
  name;
* ``idle_gaps``: the ten longest stretches in which the device ran
  nothing, each named by the innermost host operation running at its
  middle: a PyTorch operation, or a runner's span around its calls into
  the program (``girih.call``, ``girih.serve_queue``: the program's own
  Python, or the server's sleep), or ``host: python`` where none ran.
"""

from __future__ import annotations

import bisect

WINDOW_SPAN = "girih.window"
NAME_CHARS = 120


def profiled(fn):
    """``(fn(), record)``: `fn` run under `torch.profiler`, reduced."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            out = fn()
        torch.cuda.synchronize()
    events = [(e.name(), e.device_type() == DeviceType.CUDA,
               e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3,
               e.is_user_annotation())
              for e in prof.profiler.kineto_results.events()]
    return out, reduce(events)


def _union(intervals) -> tuple[float, list[tuple[float, float]]]:
    """Total length of the union of ``(start, end)`` intervals, and the
    merged intervals in order."""
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), [(a, b) for a, b in merged]


def reduce(events) -> dict:
    """The record of one traced window (see the module's docstring) from
    ``(name, on_device, start_us, end_us, is_annotation)`` events."""
    spans = [e for e in events if e[0] == WINDOW_SPAN and not e[1]]
    if not spans:
        raise RuntimeError("the profiler recorded no window span")
    w0, w1 = spans[0][2], spans[0][3]
    ops = []
    for name, on_device, a, b, note in events:
        if not on_device or note or name.startswith("girih."):
            continue
        a, b = max(a, w0), min(b, w1)
        if b > a:
            ops.append((name, (a - w0) / 1e6, (b - w0) / 1e6))
    window_s = (w1 - w0) / 1e6
    busy_s, merged = _union((a, b) for _, a, b in ops)
    by_name: dict[str, float] = {}
    for name, a, b in ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    edges = [0.0] + [x for ab in merged for x in ab] + [window_s]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    host = sorted(((a - w0) / 1e6, (b - w0) / 1e6, name)
                  for name, on_device, a, b, _ in events
                  if not on_device and name != WINDOW_SPAN)
    starts = [h[0] for h in host]
    idle = []
    for length, start in gaps:
        mid = start + length / 2
        covering = [h for h in host[:bisect.bisect_right(starts, mid)]
                    if h[1] >= mid]
        name = (min(covering, key=lambda h: h[1] - h[0])[2] if covering
                else "host: python")
        idle.append([name[:NAME_CHARS], length])
    return {"window_s": window_s, "busy_s": busy_s, "device_ops": ops,
            "top_ops": [[n[:NAME_CHARS], s] for n, s in top],
            "idle_gaps": idle}
