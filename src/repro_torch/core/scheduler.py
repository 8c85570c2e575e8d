"""Serving queue policy: lanes, admission control, batching windows.

The port of the serving half of `repro.core.scheduler`: a two-lane
(interactive/batch) bounded queue with admission control and backpressure
(`LaneQueue`), the deadline-aware batch-window close rule
(`window_close_s`), and the per-bucket launch-time estimator
(`ServiceEstimator`). All of it is pure host-side policy.

The estimator's dispatch overhead is a constructor argument (default
0.0); the server passes the device spec's measured `launch_s`
(`core.specs`), and no TPU constant enters it.
"""

from __future__ import annotations

import collections
import dataclasses
import math

LANES = ("interactive", "batch")        # service order: interactive first


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Backpressure knobs of the serving queue.

    `max_depth` bounds each lane's admitted-but-unserved depth; an offer
    past ``reject_watermark * max_depth`` is rejected with a retry-after
    hint so clients back off instead of queueing unboundedly.
    """

    max_depth: int = 256
    reject_watermark: float = 1.0
    retry_after_s: float = 0.05

    def __post_init__(self):
        if self.max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {self.max_depth}")
        if not 0.0 < self.reject_watermark <= 1.0:
            raise ValueError("reject_watermark must be in (0, 1], got "
                             f"{self.reject_watermark}")


class LaneQueue:
    """Two-level priority queue with bounded depth and backpressure.

    Items go into ``"interactive"`` (always drained first) or ``"batch"``,
    FIFO within a lane. `offer` returns None on admit or a retry-after hint
    (seconds) that grows with how full the lane is.
    """

    def __init__(self, policy: AdmissionPolicy | None = None):
        self.policy = policy or AdmissionPolicy()
        self._lanes: dict[str, collections.deque] = {
            lane: collections.deque() for lane in LANES}

    def offer(self, item, lane: str = "batch") -> float | None:
        """Admit `item` into `lane`; None on admit, retry-after (s) if full."""
        if lane not in self._lanes:
            raise ValueError(f"unknown lane {lane!r}; lanes: {LANES}")
        q = self._lanes[lane]
        limit = self.policy.reject_watermark * self.policy.max_depth
        if len(q) >= limit:
            overfull = len(q) / max(limit, 1.0)
            return self.policy.retry_after_s * overfull
        q.append(item)
        return None

    def depth(self, lane: str | None = None) -> int:
        """Admitted-but-unserved items in `lane` (or across both lanes)."""
        if lane is not None:
            return len(self._lanes[lane])
        return sum(len(q) for q in self._lanes.values())

    def __len__(self) -> int:
        return self.depth()

    def head(self):
        """``(item, lane)`` next to serve — interactive lane first — or None."""
        for lane in LANES:
            if self._lanes[lane]:
                return self._lanes[lane][0], lane
        return None

    def items(self):
        """All admitted items in service order (interactive lane first)."""
        for lane in LANES:
            yield from self._lanes[lane]

    def remove(self, items) -> None:
        """Drop `items` (a served batch) from whichever lanes hold them."""
        drop = {id(x) for x in items}
        for lane in LANES:
            self._lanes[lane] = collections.deque(
                x for x in self._lanes[lane] if id(x) not in drop)


def window_close_s(now_s: float, window_s: float,
                   deadline_s: float = math.inf,
                   predicted_launch_s: float = 0.0,
                   margin_s: float = 0.0) -> float:
    """Absolute close time of a batching window, deadline-aware.

    At most `window_s` past `now_s`, closed early so the head can still make
    ``deadline - predicted_launch - margin``; never before `now_s`.
    """
    close = now_s + window_s
    if math.isfinite(deadline_s):
        close = min(close, deadline_s - predicted_launch_s - margin_s)
    return max(now_s, close)


class ServiceEstimator:
    """Per-bucket EWMA of measured per-item launch time.

    `observe` folds in one measured launch; `predict` returns the wall time
    of a B-item launch under the batch-amortization model
    ``B * t_item + dispatch_s`` (one dispatch per batched launch). With no
    observation yet it predicts 0.0, so the window closes on the deadline.
    """

    def __init__(self, alpha: float = 0.4, dispatch_s: float = 0.0):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if dispatch_s < 0.0:
            raise ValueError(f"dispatch_s must be >= 0, got {dispatch_s}")
        self.alpha = alpha
        self.dispatch_s = dispatch_s
        self._t_item: dict = {}

    def observe(self, key, batch: int, launch_s: float) -> None:
        """Record one measured launch of `batch` items under bucket `key`."""
        t_item = max(launch_s - self.dispatch_s, 0.0) / max(batch, 1)
        old = self._t_item.get(key)
        self._t_item[key] = (t_item if old is None
                             else self.alpha * t_item + (1 - self.alpha) * old)

    def predict(self, key, batch: int) -> float:
        """Predicted wall time (s) of a `batch`-item launch for bucket `key`."""
        t_item = self._t_item.get(key)
        if t_item is None:
            return 0.0
        return max(batch, 1) * t_item + self.dispatch_s
