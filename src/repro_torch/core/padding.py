"""Padding classes and masked operator variants for ragged batched serving.

The port of `repro.core.padding`. A `PaddingLadder` maps a grid shape to
its padding class (the per-axis next rung: a power of two, a rung list, or
the exact extent); requests of one class share one batched launch at the
class shape.

Padding a Dirichlet grid is not free: the original high boundary ring
(width R, frozen by the sweep's carried frame) becomes interior of the
padded grid and would start evolving. `pad_problem` and `pad_batch`
therefore build a masked problem whose frozen region, everything outside
the original interior, keeps its values exactly, so the padded launch,
cropped, equals each request's unpadded run under the same plan:

* 1st-order ops: every coefficient stream holds the original values on the
  original interior; on the frozen region the centre group's stream is 1
  and every other stream 0, so a frozen cell updates to ``1*c + 0*S`` =
  `c`. Compile-time scalars are promoted to per-cell streams by
  `masked_variant`, each filled with the scalar rounded once to the stream
  dtype.
* 2nd-order ops (``U = 2V - U_prev + scale*L``): only the scale stream is
  masked to 0 on the frozen region, and `prev` is set to `cur` there, so a
  frozen cell updates to ``2c - c + 0`` = `c` exactly. A const or absent
  scale is promoted or synthesized as above.

The only inexactness is on frozen cells holding ``-0.0``, which come back
as ``+0.0`` (``-0.0 + 0.0 == +0.0``); `torch.equal` does not tell the two
apart. Interior cells, the ones a request computes, take the same bits as
the unpadded run wherever the promoted stream holds the value the kernel
would have used for the scalar: at f32 and f64 always; at bf16 and fp16
when the scalar is representable in the stream dtype (`make_problem`'s
scalars are).

`masked_variant(op)` returns `op` itself where masking is pure data
(all-array 1st-order taps, or 2nd order with an array scale), so the plan
registry key and the kernel are shared with the unpadded path; only
scalar-coefficient ops get a structurally derived ``<name>+mask`` twin,
whose name, taps, groups, scale and fingerprint equal the reference's.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.core import ir
from repro_torch.core.ir import Coeff, StencilOp, Tap


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


# ---------------------------------------------------------------------------
# Masked operator variants
# ---------------------------------------------------------------------------

# Slot sources of the masked op's coefficient streams: where the per-cell
# values on the ORIGINAL INTERIOR come from. The frozen-region value is the
# per-slot freeze constant (1.0 for the centre group of a 1st-order op,
# 0.0 everywhere else).
#   ("array", k)  -> original stacked stream slot k
#   ("const", j)  -> broadcast of original scalar slot j
#   ("value", v)  -> broadcast of the literal v (synthesized centre tap)


@dataclasses.dataclass(frozen=True)
class MaskRecipe:
    """How to build a masked problem for one operator (see `masked_variant`)."""

    op: StencilOp                       # the op the padded launch runs
    sources: tuple[tuple, ...]          # per masked-array-slot value source
    freezes: tuple[float, ...]          # per-slot frozen-region constant
    scalar_map: tuple[int, ...]         # original scalar slots kept, in order


def _center_coeff(op: StencilOp) -> Coeff | None:
    for t in op.taps:
        if t.offset == (0, 0, 0):
            return t.coeff
    return None


def _promote_taps(op: StencilOp):
    """Every tap coefficient -> a fresh array slot (group order preserved).

    Returns ``(new_taps, sources)`` where slot i of the promoted op is
    described by sources[i]. Distinct original sources map to distinct slots
    in first-appearance order, so `op.groups`, and with it the sweep's
    association order, is unchanged.
    """
    slot_of: dict[Coeff, int] = {}
    sources: list[tuple] = []
    new_taps = []
    for t in op.taps:
        if t.coeff not in slot_of:
            slot_of[t.coeff] = len(sources)
            sources.append((t.coeff.kind, t.coeff.index))
        new_taps.append(Tap(t.dz, t.dy, t.dx, ir.array(slot_of[t.coeff])))
    return tuple(new_taps), tuple(sources)


@functools.lru_cache(maxsize=None)
def mask_recipe(op: StencilOp) -> MaskRecipe:
    """Masking strategy for `op` (cached per op; see the module docstring).

    The returned recipe's `op` equals the input whenever masking needs no
    structural change; otherwise it is the derived ``<name>+mask`` twin.
    """
    all_scalars = tuple(range(op.n_scalars))
    if op.time_order == 2:
        # The leading 2V - prev term freezes by data alone (prev := cur on
        # the frozen region); only the scale stream must be masked to 0.
        if op.scale is not None and op.scale.kind == "array":
            sources = tuple(("array", k) for k in range(op.n_coeff_arrays))
            return MaskRecipe(op, sources, (0.0,) * len(sources), all_scalars)
        if op.scale is not None:        # const scale -> promoted array slot
            slot = op.n_coeff_arrays
            sources = tuple(("array", k) for k in range(op.n_coeff_arrays))
            sources += ((op.scale.kind, op.scale.index),)
            kept = _renumbered_scalars(op, drop={op.scale.index})
            mop = dataclasses.replace(
                op, name=op.name + "+mask",
                taps=_remap_const_taps(op.taps, kept),
                scale=ir.array(slot), default_scalars=None)
            return MaskRecipe(mop, sources, (0.0,) * len(sources), kept)
        # no scale: L is added bare, so every tap group must freeze to 0
        taps, sources = _promote_taps(op)
        mop = dataclasses.replace(op, name=op.name + "+mask", taps=taps,
                                  default_scalars=None)
        return MaskRecipe(mop, sources, (0.0,) * len(sources), ())

    center = _center_coeff(op)
    center_alone = any(len(ts) == 1 and ts[0].offset == (0, 0, 0)
                       for _, ts in op.groups)
    if center is not None and not center_alone:
        # the centre tap shares its coefficient group with off-centre taps:
        # freezing that stream to 1 would also scale the neighbours, and
        # splitting the group changes the sweep's association order (no
        # longer bitwise). No sound mask exists: serve such ops unpadded.
        raise ValueError(
            f"{op.name}: cannot build a masked padding variant — the center "
            "tap shares its coefficient group with off-center taps; serve "
            "this operator with an exact padding ladder")
    if center is not None and all(t.coeff.kind == "array" for t in op.taps):
        # pure-data masking: same op, centre stream freezes to 1, rest to 0
        sources = tuple(("array", k) for k in range(op.n_coeff_arrays))
        freezes = tuple(1.0 if k == center.index else 0.0
                        for k in range(op.n_coeff_arrays))
        return MaskRecipe(op, sources, freezes, all_scalars)
    taps, sources = _promote_taps(op)
    if center is None:
        # synthesize a frozen-identity centre tap (appended LAST so the
        # original groups' association order is unchanged; its interior
        # contribution is an exact trailing +0.0)
        taps += (Tap(0, 0, 0, ir.array(len(sources))),)
        sources += (("value", 0.0),)
        center_slot = len(sources) - 1
    else:
        promoted = {s: i for i, s in enumerate(sources)}
        center_slot = promoted[(center.kind, center.index)]
    freezes = tuple(1.0 if i == center_slot else 0.0
                    for i in range(len(sources)))
    mop = dataclasses.replace(op, name=op.name + "+mask", taps=taps,
                              default_scalars=None)
    return MaskRecipe(mop, sources, freezes, ())


def _renumbered_scalars(op: StencilOp, drop: set[int]) -> tuple[int, ...]:
    """Original scalar slots surviving a promotion, in ascending order."""
    used = sorted({t.coeff.index for t in op.taps
                   if t.coeff.kind == "const"} - drop)
    return tuple(used)


def _remap_const_taps(taps, kept: tuple[int, ...]):
    """Renumber const slots to the kept-and-compacted numbering."""
    new_index = {orig: i for i, orig in enumerate(kept)}
    out = []
    for t in taps:
        if t.coeff.kind == "const":
            out.append(Tap(t.dz, t.dy, t.dx, ir.const(new_index[t.coeff.index])))
        else:
            out.append(t)
    return tuple(out)


def masked_variant(op: StencilOp) -> StencilOp:
    """The operator a padded batched launch runs for `op` (often `op` itself)."""
    return mask_recipe(op).op


@functools.lru_cache(maxsize=None)
def _array_runs(recipe: MaskRecipe) -> tuple[tuple[int, int, int], ...]:
    """The recipe's array-sourced slots as runs ``(slot, source slot, n)``
    of consecutive slots, so a member's streams copy in a few slices."""
    runs: list[list[int]] = []
    for slot, (kind, k) in enumerate(recipe.sources):
        if kind != "array":
            continue
        if runs and runs[-1][0] + runs[-1][2] == slot \
                and runs[-1][1] + runs[-1][2] == k:
            runs[-1][2] += 1
        else:
            runs.append([slot, k, 1])
    return tuple(tuple(r) for r in runs)


# ---------------------------------------------------------------------------
# Building the padded problem
# ---------------------------------------------------------------------------

def _rounded(v: float, dtype: torch.dtype) -> float:
    """`v` rounded once to `dtype` (as ``jnp.full(shape, v, dtype)`` rounds
    it), as an exact Python float."""
    return float(ir.from_f64(np.asarray(v, np.float64), dtype, "cpu"))


def pad_batch(op: StencilOp, states, coeffs_list, padded_shape):
    """Embed B requests of one padding class in stacked masked tensors.

    `states` are the members' ``(cur, prev)`` pairs (any shapes the class
    shape dominates), `coeffs_list` their packed coefficients, which must
    share their scalars (the kernels inline them). Returns ``(masked_op,
    (cur, prev), packed_coeffs)`` with ``(B,) + padded_shape`` levels and
    the streams stacked ``(B, A, ...)``: what `ops.mwd_batched` takes with
    no further copy. Member i of the result equals the reference's
    ``pad_problem`` of request i bitwise. Built on the requests' device:
    zero-filled levels and freeze-filled streams, then each member's grid
    (levels) and original interior (streams, and prev at 2nd order) copied
    in.
    """
    recipe = mask_recipe(op)
    padded_shape = tuple(int(p) for p in padded_shape)
    splits = [ir.split_coeffs(op, c) for c in coeffs_list]
    scalars = tuple(float(x) for x in splits[0][1])
    if any(tuple(float(x) for x in sc) != scalars for _, sc in splits[1:]):
        raise ValueError(f"{op.name}: a ragged batch must share scalar "
                         "coefficients (the kernels inline them)")
    for cur, _ in states:
        shape = tuple(cur.shape)
        if len(shape) != 3 or any(p < n for p, n in zip(padded_shape, shape)):
            raise ValueError(f"{op.name}: padded shape {padded_shape} does "
                             f"not dominate the grid {shape}")
    cur0 = states[0][0]
    b, r = len(states), op.radius
    cur_b = cur0.new_zeros((b,) + padded_shape)
    for i, (cur, _) in enumerate(states):
        nz, ny, nx = cur.shape
        cur_b[i, :nz, :ny, :nx] = cur
    prev_b = cur_b.clone()      # 2nd order: frozen cells update as 2c - c
    streams = cur0.new_zeros((b, len(recipe.sources)) + padded_shape)
    for slot, freeze in enumerate(recipe.freezes):
        if freeze:
            streams[:, slot] = freeze
    fills = [(slot, _rounded(scalars[x] if kind == "const" else x,
                             cur0.dtype))
             for slot, (kind, x) in enumerate(recipe.sources)
             if kind != "array"]
    for i, ((cur, prev), (arrays, _)) in enumerate(zip(states, splits)):
        nz, ny, nx = cur.shape
        inner = (slice(r, nz - r), slice(r, ny - r), slice(r, nx - r))
        if op.time_order == 2:
            prev_b[(i,) + inner] = prev[inner]
        elif prev is not cur:   # 1st order: prev shares no cell with cur
            prev_b[i, :nz, :ny, :nx] = prev
        for slot, k, n in _array_runs(recipe):
            streams[(i, slice(slot, slot + n)) + inner] = \
                arrays[(slice(k, k + n),) + inner]
        for slot, value in fills:
            streams[(i, slot) + inner] = value
    kept = tuple(scalars[j] for j in recipe.scalar_map)
    return recipe.op, (cur_b, prev_b), ir.join_coeffs(recipe.op, streams,
                                                      kept)


def pad_problem(op: StencilOp, state, coeffs, padded_shape):
    """Embed one request in a padding-class grid with frozen-halo masking.

    Returns ``(masked_op, (cur_p, prev_p), packed_coeffs_p)`` such that
    running `masked_op` on the padded problem for any ``n_steps >= 1`` and
    cropping with `crop_state` equals running `op` on the original problem
    (see the module docstring for what "equals" means at ``-0.0`` and at
    reduced precision). `padded_shape` must dominate the grid per axis.
    """
    mop, (cur_b, prev_b), packed = pad_batch(op, [state], [coeffs],
                                             padded_shape)
    arrays, scalars = ir.split_coeffs(mop, packed)
    return mop, (cur_b[0], prev_b[0]), ir.join_coeffs(
        mop, None if arrays is None else arrays[0], scalars)


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
