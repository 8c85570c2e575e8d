"""Diamond + wavefront space-time tiling (paper Figs. 2, 3, 6).

Diamond tiling is along y; wavefront blocking is along z; the leading
dimension x is never tiled (paper Sec. 4.1). This module computes the exact
(t, y) tessellation, tile dependencies, and the wavefront geometry; it is pure
Python/NumPy (static schedules), consumed by the executors and the scheduler.

Geometry (half-open intervals, slope R):
  Row r of diamonds is centered at time t_r = r*H with H = D_w/(2R) steps
  (the half-diamond height). For a global time t in [t_r, t_{r+1}) with
  offset tau = t - t_r:
    * contracting diamonds (row r,   centers y = (k + (r%2)/2)*D_w)
        cover [y_c - (D_w/2 - R*tau), y_c + (D_w/2 - R*tau))
    * expanding diamonds  (row r+1, centers offset by D_w/2)
        cover [y_c' - R*tau, y_c' + R*tau)
  which partitions the y line exactly at every t (tessellation property,
  verified by hypothesis tests).

A "tile" below is one diamond clipped to the domain [0,T) x [y_lo,y_hi):
it lists, per time step, the half-open y-interval it updates.

The port keeps its own copy of the reference's `repro.core.tiling`
(numpy only); the CPU tests hold every compiled table equal to the
reference's. The tables feed the CUDA MWD kernel, which runs one launch per
diamond row and one thread block per tile.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DiamondTile:
    """One diamond clipped to the domain: its per-step y-spans."""

    row: int                  # diamond row index r (center time = r*H)
    col: int                  # diamond index along y within the row
    # spans[i] = (t, y_start, y_end) for consecutive time steps
    spans: tuple[tuple[int, int, int], ...]

    @property
    def n_lups_per_x(self) -> int:
        """Lattice updates this tile performs per x-line."""
        return sum(e - s for _, s, e in self.spans)

    @property
    def t_range(self) -> tuple[int, int]:
        """Half-open [t_min, t_max+1) range of time steps with spans."""
        ts = [t for t, _, _ in self.spans]
        return min(ts), max(ts) + 1

    @property
    def y_range(self) -> tuple[int, int]:
        """Half-open y extent the tile ever updates."""
        return (min(s for _, s, _ in self.spans),
                max(e for _, _, e in self.spans))


@dataclasses.dataclass(frozen=True)
class DiamondSchedule:
    """Complete diamond tessellation of [0,T) x [y_lo,y_hi)."""

    d_w: int                  # diamond width (y extent), multiple of 2R
    radius: int               # stencil radius R
    t_total: int
    y_lo: int
    y_hi: int
    rows: tuple[tuple[DiamondTile, ...], ...]   # rows in dependency order

    @property
    def half_height(self) -> int:
        """H = D_w / 2R: time steps per diamond half."""
        return self.d_w // (2 * self.radius)

    def tiles(self) -> Iterator[DiamondTile]:
        """All tiles, rows in dependency order."""
        for row in self.rows:
            yield from row

    def dependencies(self, tile: DiamondTile) -> list[tuple[int, int]]:
        """(row, col) keys of tiles that must complete before `tile` starts.

        A diamond depends on the (up to two) diamonds of the previous row
        whose y-extent overlaps its own, extended by R (the stencil reach).
        """
        if tile.row == 0:
            return []
        prev = {t.col: t for t in self.rows_by_index().get(tile.row - 1, ())}
        lo, hi = tile.y_range
        lo, hi = lo - self.radius, hi + self.radius
        deps = []
        for t in prev.values():
            plo, phi = t.y_range
            if plo < hi and lo < phi:
                deps.append((t.row, t.col))
        return deps

    def rows_by_index(self) -> dict[int, tuple[DiamondTile, ...]]:
        """Map diamond-row index -> that row's tiles."""
        return {row[0].row: row for row in self.rows if row}


def _diamond_spans(row: int, col: int, d_w: int, radius: int,
                   t_total: int, y_lo: int, y_hi: int):
    """Half-open (t, y0, y1) spans of diamond (row, col), domain-clipped."""
    h = d_w // (2 * radius)
    t_c = row * h
    y_c2 = 2 * col * d_w + (d_w if row % 2 else 0) + 2 * y_lo  # 2*center
    spans = []
    for t in range(max(0, t_c - h), min(t_total, t_c + h)):
        tau = t - t_c  # in [-h, h)
        if tau < 0:
            # expanding: width grows from 0; at offset tau'=t-(t_c-h) from the
            # base, halfwidth = R*tau' = R*(tau+h)
            w2 = 2 * radius * (tau + h)          # 2*halfwidth
        else:
            w2 = d_w - 2 * radius * tau          # contracting
        if w2 <= 0:
            continue
        y0 = max(y_lo, (y_c2 - w2) // 2)
        y1 = min(y_hi, (y_c2 + w2) // 2)
        if y1 > y0:
            spans.append((t, y0, y1))
    return tuple(spans)


def make_diamond_schedule(d_w: int, radius: int, t_total: int,
                          y_lo: int, y_hi: int) -> DiamondSchedule:
    """Exact diamond tessellation of [0, t_total) x [y_lo, y_hi)."""
    if d_w % (2 * radius) != 0:
        raise ValueError(f"d_w={d_w} must be a multiple of 2R={2*radius}")
    h = d_w // (2 * radius)
    n_rows = (t_total + h - 1) // h + 1
    ny = y_hi - y_lo
    rows = []
    for r in range(n_rows):
        row_tiles = []
        # columns whose diamond [y_c - d_w/2, y_c + d_w/2) intersects domain
        first_col = -1 if r % 2 else -1
        last_col = ny // d_w + 1
        for k in range(first_col, last_col + 1):
            spans = _diamond_spans(r, k, d_w, radius, t_total, y_lo, y_hi)
            if spans:
                row_tiles.append(DiamondTile(row=r, col=k, spans=spans))
        if row_tiles:
            rows.append(tuple(row_tiles))
    return DiamondSchedule(d_w=d_w, radius=radius, t_total=t_total,
                           y_lo=y_lo, y_hi=y_hi, rows=tuple(rows))


# ---------------------------------------------------------------------------
# Schedule compiler: DiamondSchedule -> dense static launch tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CompiledSchedule:
    """A DiamondSchedule flattened into dense arrays for the MWD kernel.

    The CUDA MWD kernel (kernels/stencil_mwd.py) runs one launch per row
    and one thread block per (tile, batch entry), looping over the
    wavefront steps inside; everything data-dependent about the
    tessellation is precompiled here into int32 tables indexed by
    (row position, tile position):

      t_base[i]        first global time step of row pass i (may be negative:
                       row 0's expanding half lies before t=0 and is clipped)
      parity[i]        t_base[i] mod 2 — which buffer holds the time level
                       t_base at the start of the pass (two-buffer scheme)
      w0[i, k]         unclipped window start along y (domain coordinates,
                       may be negative; the kernel adds its pad offset):
                       diamond center - D_w/2 - R
      y0/y1[i, k, tau] half-open update range at in-tile step tau; 0/0 where
                       the (clipped) diamond has no span at that step
      active[i, k]     1 iff the tile owns at least one span — inactive edge
                       tiles are skipped by the fused kernel (saved streams)
      order            row-major (row, col) launch order over active tiles,
                       validated against DiamondSchedule.dependencies()

    Rows are in dependency order; tiles within a row are independent (their
    mutual reads touch only the parity level a same-row neighbor never
    overwrites — see DESIGN.md), so row-major order is a legal linearization
    of the tile DAG, which compile_schedule() asserts, and the tiles of one
    row may also run concurrently.
    """

    d_w: int
    radius: int
    t_total: int
    y_lo: int
    y_hi: int
    n_rows: int
    n_tiles: int
    cols: tuple[int, ...]         # tile position k -> diamond column id
    t_base: np.ndarray            # (n_rows,) int32
    parity: np.ndarray            # (n_rows,) int32
    w0: np.ndarray                # (n_rows, n_tiles) int32
    y0: np.ndarray                # (n_rows, n_tiles, t_steps) int32
    y1: np.ndarray                # (n_rows, n_tiles, t_steps) int32
    active: np.ndarray            # (n_rows, n_tiles) int32
    order: tuple[tuple[int, int], ...]

    @property
    def t_steps(self) -> int:
        """In-tile updates per pass: T = D_w / R = 2 * half_height."""
        return self.d_w // self.radius

    @property
    def n_active(self) -> int:
        """Number of (row, tile) slots that own at least one span."""
        return int(self.active.sum())


def compile_schedule(sched: DiamondSchedule) -> CompiledSchedule:
    """Flatten `sched` into dense launch tables (see CompiledSchedule).

    Raises ValueError if the row-major launch order would violate the tile
    dependency DAG (cannot happen for schedules built by
    make_diamond_schedule; the check guards future schedule generators).
    """
    d_w, r = sched.d_w, sched.radius
    h = sched.half_height
    t_steps = 2 * h
    ny = sched.y_hi - sched.y_lo
    cols = tuple(range(-1, ny // d_w + 2))
    rows = sched.rows_by_index()
    row_indices = sorted(rows)
    n_rows, n_tiles = len(row_indices), len(cols)

    t_base = np.zeros(n_rows, np.int32)
    w0 = np.zeros((n_rows, n_tiles), np.int32)
    y0 = np.zeros((n_rows, n_tiles, t_steps), np.int32)
    y1 = np.zeros((n_rows, n_tiles, t_steps), np.int32)
    active = np.zeros((n_rows, n_tiles), np.int32)
    order: list[tuple[int, int]] = []
    done: set[tuple[int, int]] = set()

    for i, row_idx in enumerate(row_indices):
        t_base[i] = (row_idx - 1) * h
        by_col = {t.col: t for t in rows[row_idx]}
        row_start = len(order)
        for k, col in enumerate(cols):
            center = col * d_w + sched.y_lo + (d_w // 2 if row_idx % 2 else 0)
            w0[i, k] = center - d_w // 2 - r
            tile = by_col.get(col)
            if tile is None:
                continue
            for (t, a, b) in tile.spans:
                tau = t - t_base[i]
                if 0 <= tau < t_steps:
                    y0[i, k, tau] = a
                    y1[i, k, tau] = b
            active[i, k] = 1
            for dep in sched.dependencies(tile):
                if dep not in done:
                    raise ValueError(
                        f"row-major order violates dependency {dep} -> "
                        f"({row_idx}, {col})")
            order.append((row_idx, col))
        done.update(order[row_start:])

    return CompiledSchedule(
        d_w=d_w, radius=r, t_total=sched.t_total, y_lo=sched.y_lo,
        y_hi=sched.y_hi, n_rows=n_rows, n_tiles=n_tiles, cols=cols,
        t_base=t_base, parity=t_base % 2, w0=w0, y0=y0, y1=y1,
        active=active, order=tuple(order))


# ---------------------------------------------------------------------------
# Wavefront geometry (paper Sec. 3.3)
# ---------------------------------------------------------------------------

def wavefront_width(d_w: int, radius: int, n_f: int) -> int:
    """W_w = D_w - 2R + N_F (reduces to D_w + N_F - 2 at R=1)."""
    return d_w - 2 * radius + n_f


@dataclasses.dataclass(frozen=True)
class WavefrontPlan:
    """Geometry of the extruded-diamond wavefront along z (Fig. 3/6).

    The extruded diamond advances through z; each in-tile time step is offset
    by -R in z relative to the previous, so T_b in-tile steps need a live
    z working-set of n_f + R*(T_b-1) slabs in fast memory.
    """

    d_w: int
    radius: int
    n_f: int                  # wavefront tile width along z (slab thickness)
    t_block: int              # time steps blocked inside the wavefront

    @property
    def z_working_set(self) -> int:
        """Live z slabs needed in fast memory for the blocked steps."""
        return self.n_f + self.radius * (self.t_block - 1)
