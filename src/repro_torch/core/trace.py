"""Spans and counters of the port, on the profiler's clock.

Tracing is on exactly while a `torch.profiler` session records on the
calling thread (`torch.autograd._profiler_enabled()`): a benchmark's traced
window, or an operator's own profiler session. There is no other switch.

* `span(name, **attrs)`: a context manager around one step of the work.
  Off, it takes no timestamp and keeps nothing. On, it enters a profiler
  record function called `name` (the C++ one `torch.profiler`'s own fast
  paths use: about a tenth of ``record_function``'s host cost), so the step
  shows on the profiler's timeline beside the device's operations, and
  keeps a `Span` in memory on ``time.perf_counter_ns``, its parent the
  innermost span open on the thread.
* `record(name, start, end, **attrs)`: a span whose times are already
  known and may overlap others (one request's wait, say), kept only while
  tracing is on.
* `counter(name)`: a `Counter` of events and the seconds they took, always
  on; for rare or per-call points only. ``trace.counts()`` reads them all.
  ``counter.timed(span)`` also keeps the block as a span by `record`: a
  wait on the device (``girih.sync``) is kept so, since a profiler event
  at its end would land where the device has just drained.

Program spans are named ``girih.<layer>...``; the benchmark leaves that
prefix out of the device's operations, and its own spans are
``girih.window``, ``girih.call`` and ``girih.serve_queue``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import torch


@dataclasses.dataclass(eq=False)
class Span:
    """One kept span: ``start``/``end`` in ``perf_counter_ns``, the span it
    opened under (or None) and its attributes."""

    name: str
    start: int
    end: int = 0
    parent: Span | None = None
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        """The span's length in seconds."""
        return (self.end - self.start) / 1e9

    def under(self, name: str) -> Span | None:
        """The nearest enclosing span called `name`, or None."""
        p = self.parent
        while p is not None and p.name != name:
            p = p.parent
        return p


@dataclasses.dataclass
class Counter:
    """A count of events and the seconds they took, always on."""

    name: str
    count: int = 0
    seconds: float = 0.0

    @contextlib.contextmanager
    def timed(self, span: str | None = None):
        """Count the block once and add its host seconds; while tracing is
        on, also keep the block as a span called `span` (by `record`: in
        memory only, with no profiler event at either end)."""
        t = time.perf_counter_ns()
        try:
            yield self
        finally:
            end = time.perf_counter_ns()
            self.count += 1
            self.seconds += (end - t) / 1e9
            if span is not None:
                record(span, t, end)


_SPANS: list[Span] = []
_COUNTERS: dict[str, Counter] = {}
_LOCAL = threading.local()
_OFF = contextlib.nullcontext()


def enabled() -> bool:
    """Whether a profiler session records on this thread."""
    return torch.autograd._profiler_enabled()


def _stack() -> list[Span]:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _Open:
    """The context of one span while tracing is on."""

    __slots__ = ("span", "_fn")

    def __init__(self, name: str, attrs: dict):
        self.span = Span(name, 0, attrs=attrs)
        self._fn = torch._C._profiler._RecordFunctionFast(name)

    def __enter__(self) -> Span:
        stack = _stack()
        self.span.parent = stack[-1] if stack else None
        stack.append(self.span)
        self._fn.__enter__()
        self.span.start = time.perf_counter_ns()
        return self.span

    def __exit__(self, *exc) -> bool:
        self.span.end = time.perf_counter_ns()
        self._fn.__exit__(*exc)
        _stack().pop()
        _SPANS.append(self.span)
        return False


def span(name: str, **attrs):
    """A context manager spanning one step; yields its `Span`, or None
    while tracing is off."""
    return _Open(name, attrs) if enabled() else _OFF


def record(name: str, start: int, end: int, **attrs) -> None:
    """Keep a span from `start` to `end` (``perf_counter_ns``) under the
    innermost open span, if tracing is on."""
    if enabled():
        stack = _stack()
        _SPANS.append(Span(name, start, end, stack[-1] if stack else None,
                           attrs))


def spans(name: str | None = None) -> list[Span]:
    """The kept spans called `name` (every one if None), in the order they
    closed."""
    return [s for s in _SPANS if name is None or s.name == name]


def counter(name: str) -> Counter:
    """The process's counter called `name`, made on first use."""
    if name not in _COUNTERS:
        _COUNTERS[name] = Counter(name)
    return _COUNTERS[name]


def counts() -> dict[str, tuple[int, float]]:
    """Every counter's ``(count, seconds)``."""
    return {n: (c.count, c.seconds) for n, c in _COUNTERS.items()}


def reset() -> None:
    """Drop the kept spans and zero every counter."""
    _SPANS.clear()
    for c in _COUNTERS.values():
        c.count, c.seconds = 0, 0.0
