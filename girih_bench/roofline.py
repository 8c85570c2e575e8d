"""Frozen peaks, and the least time one call of a cell could take.

The peaks are NVIDIA's H100 SXM data-sheet figures, fixed here so that no
change to the program's own device spec moves a roofline share. The f64
peak is the tensor cores' rate, the highest f64 rate the card has, so the
bound is a true lower bound for any implementation.

The counts come from the configuration's file (``counts``): flops per
lattice update as the paper's Table 1 counts them (Malas et al. 2015),
and the input grids one call reads. The compulsory bytes of a call are
each input grid read once and the two output levels written once,
whatever the kernel reads again.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}
WORD_BYTES = {"float64": 8, "float32": 4}
OUTPUT_GRIDS = 2


def call_bound(config: dict, grid, steps: int, batch: int = 1) -> dict:
    """Least time of one call advancing `batch` grids of `grid` by `steps`.

    Returns the bytes' and the flops' times in seconds, the larger of the
    two (``seconds``), which one binds (``by``), the lattice updates, the
    bytes and the flops.
    """
    counts, dtype = config["counts"], config["dtype"]
    cells = batch * math.prod(grid)
    lups = cells * steps
    n_bytes = (counts["input_grids"] + OUTPUT_GRIDS) * cells * WORD_BYTES[dtype]
    flops = counts["flops_per_lup"] * lups
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_flops = flops / PEAK_FLOPS[dtype]
    return {"bytes_s": t_bytes, "flops_s": t_flops,
            "seconds": max(t_bytes, t_flops),
            "by": "bytes" if t_bytes >= t_flops else "flops", "lups": lups,
            "bytes": n_bytes, "flops": flops}
