"""HBM traffic of the port's kernels, counted from their own schedules.

The port of `repro.core.traffic`. The reference counts the TPU kernels'
DMA slabs; these count what the CUDA kernels move if no CTA reuses another
CTA's bytes (an upper estimate; the compulsory bytes, every input read and
every output written once, are the lower one):

* K1 (`mwd_pass_traffic`, `mwd_run_traffic`): per diamond row, one launch,
  both parity grids over the windows and the coefficient streams once,
  both grids written (`models.mwd_schedule_bytes`); the per-row mode also
  copies both padded grids before each row and runs every tile;
* K2 (`spatial_pass_traffic`): one step at the kernel's own tiling
  (`models.sweep_tile_bytes`);
* K3 (`ghostzone_pass_traffic`): one pass at the kernel's own tiling
  (`models.fused_window_bytes`).
"""

from __future__ import annotations

import math

from repro_torch.core import models
from repro_torch.core.precision import DEFAULT_WORD_BYTES
from repro_torch.core.stencils import StencilSpec


def mwd_pass_traffic(spec: StencilSpec, grid_shape, d_w: int, n_f: int,
                     word: int = DEFAULT_WORD_BYTES) -> dict:
    """Bytes of ONE K1 launch (one diamond row), which advances D_w/2R steps."""
    h = d_w // (2 * spec.radius)
    bytes_pass = models.mwd_schedule_bytes(spec, grid_shape, d_w, 1, word)
    lups = math.prod(grid_shape) * h
    return {"bytes": float(bytes_pass), "lups": float(lups),
            "code_balance": bytes_pass / lups, "rows_per_pass": 1,
            "steps_per_pass": h}


def mwd_run_traffic(spec: StencilSpec, grid_shape, n_steps: int, d_w: int,
                    n_f: int, word: int = DEFAULT_WORD_BYTES,
                    fused: bool = True) -> dict:
    """Bytes of a whole K1 advance of `n_steps`, one launch per row.

    ``fused=False`` adds the per-row mode's copies of both padded grids
    and its inactive tiles (`models.k1_predict`, whose bytes these are).
    """
    pred = models.k1_predict(spec, grid_shape, d_w, n_f, n_steps,
                             fused=fused, word=word)
    lups = math.prod(grid_shape) * n_steps
    return {"bytes": float(pred.hbm_bytes), "lups": float(lups),
            "code_balance": pred.hbm_bytes / lups if lups else 0.0,
            "launches": pred.launches, "rows": pred.launches}


def ghostzone_pass_traffic(spec: StencilSpec, grid_shape, t_block: int,
                           bz: int, by: int,
                           word: int = DEFAULT_WORD_BYTES) -> dict:
    """Bytes of one K3 pass of `t_block` steps at the kernel's tiling."""
    b = models.fused_window_bytes(spec, grid_shape, t_block, bz, by, word)
    lups = math.prod(grid_shape) * t_block
    return {"bytes": float(b), "lups": float(lups), "code_balance": b / lups}


def spatial_pass_traffic(spec: StencilSpec, grid_shape, bz: int,
                         word: int = DEFAULT_WORD_BYTES) -> dict:
    """Bytes of one K2 step at the kernel's tiling."""
    b = models.sweep_tile_bytes(spec, grid_shape, bz, word)
    lups = math.prod(grid_shape)
    return {"bytes": float(b), "lups": float(lups), "code_balance": b / lups}
