"""Inputs drawn from the seed, as a configuration's ``draw`` states them.

Solution levels and coefficient arrays are standard-normal draws of
`torch.Generator` on the run's device, in the configuration's dtype, one
call a tensor; the arrays are then scaled by ``coeff_scale``. Scalars are
the configuration's own numbers. The same seed gives the same inputs, and
both the program and the reference are handed these same tensors.
"""

from __future__ import annotations

import dataclasses

import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32}


@dataclasses.dataclass(eq=False)
class Problem:
    """One grid's inputs: ``state = (cur, prev)`` (the same tensor for a
    first-order operator), the stacked arrays (or None), the scalars."""

    state: tuple
    arrays: torch.Tensor | None
    scalars: tuple

    @property
    def coeffs(self):
        """The coefficients packed as the program's entry points take them:
        the arrays, the scalars, or both as ``(arrays, scalars)``."""
        if self.arrays is not None and self.scalars:
            return (self.arrays, self.scalars)
        return self.arrays if self.arrays is not None else self.scalars


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` seeded with `seed` (any whole number >= 0)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def levels(config: dict, grid, gen, device) -> tuple:
    """The initial ``(cur, prev)`` of one grid."""
    dt = DTYPES[config["dtype"]]
    n = config["draw"]["levels"]
    drawn = torch.randn((n, *grid), generator=gen, dtype=dt, device=device)
    return (drawn[0], drawn[1]) if n == 2 else (drawn[0], drawn[0])


def coefficients(config: dict, grid, gen, device):
    """The scaled coefficient arrays ``(A, *grid)`` (or None) and the
    scalars of one grid."""
    draw = config["draw"]
    arrays = None
    if draw["coeff_arrays"]:
        arrays = torch.randn((draw["coeff_arrays"], *grid), generator=gen,
                             dtype=DTYPES[config["dtype"]], device=device)
        arrays.mul_(draw["coeff_scale"])
    return arrays, tuple(float(x) for x in draw["scalars"])
