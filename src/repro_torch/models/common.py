"""Activation sharding constraints (MaxText-style logical activation axes).

The port of `repro.models.common`. The reference pins activations to mesh
axes with ``with_sharding_constraint`` and drops the axes its mesh lacks.
The port runs one process that holds every tensor whole on one device
(`training.sharding.place` refuses a real split until the sharded LM
step, ROADMAP.md queue 1 item 14a), so `constrain` is the identity: the
model code keeps the reference's call sites and their logical axes, and a
sharded activation layout has one place to go.
"""

from __future__ import annotations

BATCH = ("pod", "data")
MODEL = "model"


def constrain(x, *axes):
    """`x` unchanged; `axes` name its logical layout, one entry a dim."""
    return x
