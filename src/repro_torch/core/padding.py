"""Padding ladders of the serving tier: the exact-fit part.

The port of the ladder half of `repro.core.padding`. A `PaddingLadder`
maps a grid shape to its padding class; requests of one class may share a
batched launch. Only exact classes (every shape its own class) are served
so far: the frozen-halo masking that lets smaller grids ride a larger
class (`masked_variant`, `pad_problem` in the reference) is not ported yet,
and the port's server refuses any other ladder instead of padding.
"""

from __future__ import annotations

import dataclasses
import math


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    if n < 1:
        raise ValueError(f"extent must be >= 1, got {n}")
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class PaddingLadder:
    """Per-axis padding-class boundaries.

    ``mode`` is ``"exact"`` (every shape is its own class), ``"pow2"``
    (next power of two per axis), or ``"rungs"`` with a sorted `rungs`
    tuple (an extent beyond the last rung keeps its exact size).
    """

    mode: str = "exact"
    rungs: tuple[int, ...] = ()

    def __post_init__(self):
        if self.mode not in ("exact", "pow2", "rungs"):
            raise ValueError(f"unknown ladder mode {self.mode!r}")
        if self.mode == "rungs":
            if not self.rungs:
                raise ValueError("rungs mode needs at least one rung")
            object.__setattr__(self, "rungs",
                               tuple(sorted(int(r) for r in self.rungs)))
            if self.rungs[0] < 1:
                raise ValueError(f"rungs must be >= 1, got {self.rungs}")

    def padded_extent(self, n: int) -> int:
        """Class extent of one axis: the first rung >= n (n itself if none)."""
        if n < 1:
            raise ValueError(f"extent must be >= 1, got {n}")
        if self.mode == "exact":
            return n
        if self.mode == "pow2":
            return next_pow2(n)
        for r in self.rungs:
            if r >= n:
                return r
        return n

    def padded_shape(self, shape) -> tuple[int, ...]:
        """Padding class of a grid: per-axis `padded_extent`."""
        return tuple(self.padded_extent(int(n)) for n in shape)


EXACT = PaddingLadder("exact")
POW2 = PaddingLadder("pow2")


def parse_ladder(spec) -> PaddingLadder:
    """A `PaddingLadder`, None / ``"exact"``, ``"pow2"`` or rungs ``"8,16"``."""
    if isinstance(spec, PaddingLadder):
        return spec
    if spec is None or spec == "exact":
        return EXACT
    if spec == "pow2":
        return POW2
    return PaddingLadder("rungs", tuple(int(x) for x in str(spec).split(",")))


def crop_state(state, shape):
    """Crop one (cur, prev) pair back to the request's original grid."""
    nz, ny, nx = shape
    return tuple(a[..., :nz, :ny, :nx] for a in state)


def padding_waste(shapes, padded_shape) -> float:
    """Padded-cells overhead of one batch: extra cells / real cells."""
    shapes = [tuple(s) for s in shapes]
    real = sum(math.prod(s) for s in shapes)
    padded = len(shapes) * math.prod(padded_shape)
    return (padded - real) / real if real else 0.0
