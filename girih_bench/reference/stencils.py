"""Plain PyTorch time stepping of stencil operators, from frozen taps.

Independent of the program: each operator's taps are this folder's own
copy, one file an operator (``operators/<name>.json``; the paper's are
copied from its Listings, Malas et al. 2015), and nothing here imports the
program. Grids are ``(z, y, x)``; a step updates the interior ``[R:-R]``
of every axis and carries the Dirichlet frame unchanged; the state is
``(cur, prev)`` and a step maps it to ``(new, cur)``.

Per group of taps that share a coefficient, the taps are summed left to
right and the sum multiplied once by the coefficient; groups accumulate in
the listed order. Second order in time: ``new = (2 cur - prev) + scale *
sum``. Each operation is its own PyTorch call and rounds to the working
dtype.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import torch

OPERATORS_DIR = Path(__file__).resolve().with_name("operators")


@functools.lru_cache(maxsize=None)
def load(name: str, root: Path = OPERATORS_DIR) -> dict:
    """Operator `name`'s frozen taps, from ``<root>/<name>.json``: its
    radius, time order, groups of (coefficient kind, slot, tap offsets) and
    the second-order scale's (kind, slot) or None."""
    path = Path(root) / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(
            f"no reference taps for operator {name!r}: {path} not found")
    op = json.loads(path.read_text())
    return {"radius": op["radius"], "time_order": op["time_order"],
            "scale": (None if op["scale"] is None
                      else tuple(op["scale"])),
            "groups": tuple((kind, slot, tuple(tuple(o) for o in offs))
                            for kind, slot, offs in op["groups"])}


def name_of(config: dict) -> str:
    """The reference operator a configuration is judged by: its
    ``"reference"``, or else its ``"operator"`` (a paper operator's name)."""
    return config.get("reference", config["operator"])


def step(operator: str, cur, prev, arrays, scalars, reverse: bool = False):
    """One time step of the reference operator named `operator` (see
    `load`): ``(cur, prev) -> (new, cur)``.

    `arrays` is the stacked ``(A, nz, ny, nx)`` coefficient arrays (or
    None), `scalars` the constants as Python floats. `reverse` sums the
    groups and the taps in each in the opposite order: the same update,
    rounded differently, as a sound reordering of the program would be.
    """
    op = load(operator)
    groups = op["groups"]
    if reverse:
        groups = [(k, slot, offs[::-1]) for k, slot, offs in groups[::-1]]
    r = op["radius"]
    nz, ny, nx = cur.shape
    box = (slice(r, nz - r), slice(r, ny - r), slice(r, nx - r))

    def at(a, off):
        dz, dy, dx = off
        return a[r + dz:nz - r + dz, r + dy:ny - r + dy, r + dx:nx - r + dx]

    def coeff(kind, slot):
        return scalars[slot] if kind == "const" else arrays[slot][box]

    acc = None
    for kind, slot, offsets in groups:
        s = at(cur, offsets[0]).clone()
        for off in offsets[1:]:
            s.add_(at(cur, off))
        s.mul_(coeff(kind, slot))
        if acc is None:
            acc = s
        else:
            acc.add_(s)
            del s
    if op["time_order"] == 2:
        lead = at(cur, (0, 0, 0)) * 2.0
        lead.sub_(at(prev, (0, 0, 0)))
        if op["scale"] is not None:
            acc.mul_(coeff(*op["scale"]))
        acc = lead.add_(acc)
    new = cur.clone()
    new[box] = acc
    return new, cur


def advance(operator: str, state, arrays, scalars, n_steps: int,
            dtype: torch.dtype | None = None, reverse: bool = False):
    """`n_steps` steps from `state`; with `dtype` every input is first cast
    to it and the arithmetic runs in it (`reverse`: see `step`). Returns
    ``(cur, prev)``."""
    cur, prev = state
    if dtype is not None:
        cur, prev = cur.to(dtype), prev.to(dtype)
        arrays = arrays.to(dtype) if arrays is not None else None
        scalars = [float(torch.tensor(x, dtype=dtype)) for x in scalars]
    for _ in range(n_steps):
        cur, prev = step(operator, cur, prev, arrays, scalars, reverse)
    return cur, prev
