"""The comparison that decides `correct`: the program's answer against the
plain reference, block by block.

`block_gap` splits the grid into 4x4x4 blocks and reads, in each, the
largest difference over the largest magnitude of the reference there; the
gap is the largest of these. A block normalizes by its own scale, so a
wrong value deep inside the grid, where the solution has decayed far below
the Dirichlet frame's magnitude, counts as much as one beside the frame.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

BLOCK = 4
NOT_FINITE = 1.0e308        # the gap of an answer that holds inf or nan
LIMITS_DIR = Path(__file__).resolve().with_name("limits")


def block_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest per-block ``max |got - want| / max |want|`` over the grid."""
    if tuple(got.shape) != tuple(want.shape):
        return NOT_FINITE
    got = got.to(want.dtype)
    if not bool(torch.isfinite(got).all()):
        return NOT_FINITE
    diff = F.max_pool3d((got - want).abs_()[None], BLOCK, BLOCK,
                        ceil_mode=True)
    scale = F.max_pool3d(want.abs()[None], BLOCK, BLOCK, ceil_mode=True)
    tiny = torch.finfo(want.dtype).tiny
    return float((diff / scale.clamp_min(tiny)).max())


def state_gap(got, want) -> float:
    """The larger `block_gap` of the two levels ``(cur, prev)``."""
    return max(block_gap(got[0], want[0]), block_gap(got[1], want[1]))


def limits(workload: str, root: Path = LIMITS_DIR) -> dict:
    """The limits of a cell's compared numbers (``<root>/<cell>.json``,
    the benchmark's ``limits/`` by default)."""
    return json.loads((Path(root) / f"{workload}.json").read_text())


def verdict(numbers: dict, limit: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every number within its
    limit, and every limit's number present."""
    shown = {name: {"value": numbers.get(name), "limit": lim}
             for name, lim in limit.items()}
    ok = all(v["value"] is not None and v["value"] <= v["limit"]
             for v in shown.values())
    return ok, shown


def print_check(shown: dict) -> None:
    """The compared numbers beside their limits, as the last lines on
    standard error."""
    for name, v in shown.items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
