"""Activation sharding constraints (MaxText-style logical activation axes).

The port of `repro.models.common`. The reference pins activations to mesh
axes with ``with_sharding_constraint`` and drops the axes its mesh lacks,
and GSPMD derives the collectives from those layouts. The port states the
layouts where they are made instead: the sharded LM step
(`training.spmd`) holds each rank's blocks (`training.sharding.place`),
gathers parameters along 'data' inside each block (`spmd.gather_data`),
and splits heads, the MLP's width and the vocab over 'model' in
`models.layers` and `models.lm` (`spmd.enter_model`,
`spmd.reduce_model`, the vocab-parallel lookup and loss). So `constrain`
is the identity: the model code keeps the reference's call sites and
their logical axes as documentation of the layout at each point.
"""

from __future__ import annotations

BATCH = ("pod", "data")
MODEL = "model"


def constrain(x, *axes):
    """`x` unchanged; `axes` name its logical layout, one entry a dim."""
    return x
