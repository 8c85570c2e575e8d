"""Declarative stencil IR: one operator description drives every layer.

The port of `repro.core.ir`. A `StencilOp` is a list of taps
``(dz, dy, dx, coeff)`` plus the time order; a coefficient source is a
compile-time scalar (``const(j)``) or a per-cell stream (``array(k)``, slot
``k`` of one stacked ``(A, Nz, Ny, Nx)`` tensor). ``time_order == 2``
selects ``U = 2*V - U_prev [+ scale * L(V)]``.

Everything derives from the taps exactly as in the reference: `groups` (the
evaluation order), the analytics, the coefficient split/join, and the
structural `fingerprint`, whose hex digests equal the reference's so plan
keys stay comparable across packages.

The generated sweep evaluates in `op.groups` order: per group the taps are
summed left-associatively, multiplied once by the group coefficient, and
groups accumulate in first-appearance order. Each operation rounds to the
working dtype, which is the arithmetic the CUDA kernel
(`kernels/csrc/mwd.cu`) reproduces bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import importlib

import numpy as np
import torch

from repro_torch.core import precision
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Coeff:
    """One coefficient source: compile-time scalar slot or per-cell array slot."""

    kind: str                   # "const" | "array"
    index: int                  # slot in the scalar tuple / stacked array

    def __post_init__(self):
        if self.kind not in ("const", "array"):
            raise ValueError(f"coeff kind must be const|array, got {self.kind!r}")
        if self.index < 0:
            raise ValueError(f"coeff index must be >= 0, got {self.index}")

    def describe(self) -> str:
        """Canonical short form, e.g. ``c0`` / ``a3`` (used by fingerprint)."""
        return ("c" if self.kind == "const" else "a") + str(self.index)


def const(index: int) -> Coeff:
    """Compile-time scalar coefficient, slot `index` of the scalar tuple."""
    return Coeff("const", index)


def array(index: int) -> Coeff:
    """Per-cell variable coefficient, slot `index` of the stacked stream."""
    return Coeff("array", index)


@dataclasses.dataclass(frozen=True)
class Tap:
    """One stencil tap: read cur at (dz, dy, dx), weight by `coeff`."""

    dz: int
    dy: int
    dx: int
    coeff: Coeff

    @property
    def offset(self) -> tuple[int, int, int]:
        """The (dz, dy, dx) displacement of this tap."""
        return (self.dz, self.dy, self.dx)


@dataclasses.dataclass(frozen=True)
class StencilOp:
    """Declarative stencil operator: taps + time order; everything else derives.

    `default_scalars` / `coeff_scale` are problem-generation hints consumed
    by `make_problem`; `error_budget` is the per-dtype accuracy contract.
    None of them is part of the semantic `fingerprint`.
    """

    name: str
    taps: tuple[Tap, ...]
    time_order: int = 1
    scale: Coeff | None = None              # 2nd-order extra multiplier (C)
    default_scalars: tuple[float, ...] | None = None
    coeff_scale: float = 0.1
    error_budget: tuple[tuple[str, float, float], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "taps", tuple(self.taps))
        if self.default_scalars is not None:
            object.__setattr__(self, "default_scalars",
                               tuple(float(x) for x in self.default_scalars))
        object.__setattr__(
            self, "error_budget",
            tuple((str(n), float(a), float(r))
                  for n, a, r in self.error_budget))
        if not self.taps:
            raise ValueError(f"{self.name}: an operator needs at least one tap")
        if self.time_order not in (1, 2):
            raise ValueError(f"{self.name}: time_order must be 1 or 2")
        if self.scale is not None and self.time_order != 2:
            raise ValueError(f"{self.name}: scale is only meaningful for "
                             "2nd-order-in-time operators")
        offs = [t.offset for t in self.taps]
        if len(set(offs)) != len(offs):
            raise ValueError(f"{self.name}: duplicate tap offsets")
        if self.radius < 1:
            raise ValueError(f"{self.name}: at least one tap must be off-center")
        for kind, n in (("const", self.n_scalars), ("array",
                                                    self.n_coeff_arrays)):
            used = {c.index for c in self._coeffs() if c.kind == kind}
            if used != set(range(n)):
                raise ValueError(f"{self.name}: {kind} slots must be "
                                 f"contiguous from 0, got {sorted(used)}")

    def _coeffs(self):
        cs = [t.coeff for t in self.taps]
        if self.scale is not None:
            cs.append(self.scale)
        return cs

    @property
    def radii(self) -> tuple[int, int, int]:
        """Per-axis halo depth (max |offset| along z, y, x)."""
        return (max(abs(t.dz) for t in self.taps),
                max(abs(t.dy) for t in self.taps),
                max(abs(t.dx) for t in self.taps))

    @property
    def radius(self) -> int:
        """Semi-bandwidth R: the kernels pad/halo all axes to the max radius."""
        return max(max(abs(t.dz), abs(t.dy), abs(t.dx)) for t in self.taps)

    @property
    def n_scalars(self) -> int:
        """Number of compile-time scalar coefficient slots."""
        return 1 + max((c.index for c in self._coeffs() if c.kind == "const"),
                       default=-1)

    @property
    def n_coeff_arrays(self) -> int:
        """Number of domain-sized coefficient streams (stacked array slots)."""
        return 1 + max((c.index for c in self._coeffs() if c.kind == "array"),
                       default=-1)

    @property
    def groups(self) -> tuple[tuple[Coeff, tuple[Tap, ...]], ...]:
        """Taps grouped by coefficient source, in first-appearance order.

        This is the exact evaluation order of the generated sweep and of the
        CUDA kernel, which is what makes the two bitwise-comparable.
        """
        order: list[Coeff] = []
        members: dict[Coeff, list[Tap]] = {}
        for t in self.taps:
            if t.coeff not in members:
                order.append(t.coeff)
                members[t.coeff] = []
            members[t.coeff].append(t)
        return tuple((c, tuple(members[c])) for c in order)

    @property
    def flops_per_lup(self) -> int:
        """FLOPs per lattice update, counted as in the paper's Table 1."""
        n_groups = len(self.groups)
        flops = len(self.taps) + n_groups - 1
        if self.time_order == 2:
            flops += 3 if self.scale is None else 4
        elif n_groups >= 2 and all(c.kind == "const" for c, _ in self.groups):
            flops -= 1      # all-constant 1st-order: one accumulate is an FMA
        return flops

    @property
    def n_streams(self) -> int:
        """N_D of Eqs. 4-5: read streams incl. the destination write-allocate."""
        return 2 + self.n_coeff_arrays

    @property
    def bytes_per_cell(self) -> int:
        """Domain-sized arrays touched per cell (solution levels + coeffs)."""
        return 2 + self.n_coeff_arrays

    def spatial_code_balance(
            self, word_bytes: int = precision.DEFAULT_WORD_BYTES) -> float:
        """Optimal spatial-blocking code balance, bytes/LUP (paper Sec. 5.2).

        ``word * (N_D + 1)``: all read streams plus the store.
        """
        return word_bytes * (self.n_streams + 1)

    def tolerance(self, dtype) -> tuple[float, float]:
        """Declared per-dtype error budget ``(atol, rtol)``.

        An explicit `error_budget` entry for the dtype wins; otherwise the
        dtype's machine epsilon scaled by the operator's accumulation depth.
        """
        name = precision.dtype_name(dtype)
        for n, atol, rtol in self.error_budget:
            if n == name:
                return (atol, rtol)
        eps = float(precision.finfo(dtype).eps)
        k = 4.0 * (len(self.taps) + (4 if self.time_order == 2 else 0))
        return (k * eps, k * eps)

    def adjoint(self) -> "Adjoint":
        """The adjoint operator of this op's sweep, derived structurally
        (tap offsets negated, variable coefficients transported as rolled
        streams); see `adjoint`. Cached per op."""
        return adjoint(self)

    @property
    def fingerprint(self) -> str:
        """Stable hash of the operator semantics (taps, time order, scale)."""
        parts = [f"to{self.time_order}",
                 "s:" + (self.scale.describe() if self.scale else "-")]
        parts += [f"{t.dz},{t.dy},{t.dx},{t.coeff.describe()}"
                  for t in self.taps]
        return hashlib.sha256("|".join(parts).encode()).hexdigest()[:12]


# ---------------------------------------------------------------------------
# Generated sweep
# ---------------------------------------------------------------------------

def sweep_region(op: StencilOp, cur, prev, arrays, scalars, lo, hi,
                 acc_dtype=None):
    """New values of the box ``[lo, hi)`` (trailing z, y, x axes).

    Reads `cur` at every tap offset around the box (the caller keeps the
    box at least R inside the tensor), `prev` at the box for 2nd-order ops
    and the stacked `arrays` at the box. Leading axes (a batch) pass
    through. With `acc_dtype` every read is cast up and the result cast
    back to the stream dtype; otherwise the arithmetic runs in the stream
    dtype. Python-float scalars multiply in PyTorch's opmath type, as the
    CUDA kernel does.
    """
    (z0, y0, x0), (z1, y1, x1) = lo, hi

    def at(a, off):
        dz, dy, dx = off
        v = a[..., z0 + dz:z1 + dz, y0 + dy:y1 + dy, x0 + dx:x1 + dx]
        return v if acc_dtype is None else v.to(acc_dtype)

    def cval(c: Coeff):
        if c.kind == "const":
            return scalars[c.index]
        return at(arrays[..., c.index, :, :, :], (0, 0, 0))

    acc = None
    for coeff, taps in op.groups:
        s = None
        for t in taps:
            v = at(cur, t.offset)
            s = v if s is None else s + v
        term = cval(coeff) * s
        acc = term if acc is None else acc + term
    if op.time_order == 2:
        lead = 2.0 * at(cur, (0, 0, 0)) - at(prev, (0, 0, 0))
        acc = lead + (cval(op.scale) * acc if op.scale is not None else acc)
    return acc if acc_dtype is None else acc.to(cur.dtype)


@functools.lru_cache(maxsize=None)
def make_sweep(op: StencilOp):
    """Generate the torch sweep for `op`: ``(cur, prev, arrays, scalars) -> new``.

    Same contract as the reference: the update writes the interior
    ``[R:-R]`` of every axis and carries the Dirichlet frame through;
    `arrays` is the stacked ``(A, ...)`` stream (or None) and `scalars` is
    indexable by slot.
    """
    r = op.radius

    def sweep(cur, prev, arrays, scalars):
        nz, ny, nx = cur.shape[-3:]
        out = cur.clone()
        out[..., r:nz - r, r:ny - r, r:nx - r] = sweep_region(
            op, cur, prev, arrays, scalars, (r, r, r),
            (nz - r, ny - r, nx - r))
        return out

    return sweep


# ---------------------------------------------------------------------------
# Structural adjoint: the transpose of the sweep is another StencilOp
# ---------------------------------------------------------------------------
#
# The sweep is linear in the solution levels:
#
#   1st order:  out[i] = sum_t  c_t(i) * cur[i + off_t]
#   2nd order:  out[i] = 2*cur[i] - prev[i] + s(i) * sum_t c_t(i)*cur[i+off_t]
#
# The cotangent flowing into cur[j] from output cell i = j - off_t is
# weighted by c_t(i), the coefficient at the forward output cell. So the
# adjoint is a stencil with taps at the negated offsets whose coefficients
# are the same compile-time scalar where c_t is const and the 2nd-order
# scale is const or absent, and otherwise a shifted copy of the forward
# stream, c'_t[j] = w_t[j - off_t], with w_t the tap's array stream times
# (when the scale is an array) the scale stream: one torch.roll per adjoint
# slot. Wrapped values land only where the cotangent is zero (outside the
# interior), so the roll is exact. The 2nd-order recurrence transposes to
# itself over the adjoint taps, up to the sign of the previous level's
# cotangent, which `kernels.adjoint` applies to the state.


@dataclasses.dataclass(frozen=True)
class AdjointSlot:
    """Recipe for one adjoint coefficient stream (one forward tap).

    ``stream[j] = roll(prod(arrays[k] for k) * prod(scalars[i] for i),
    shift)``; `shift` is the forward tap offset (a roll by +off evaluates
    at ``j - off``).
    """

    shift: tuple[int, int, int]
    arrays: tuple[int, ...]         # forward array slots multiplied in
    scalars: tuple[int, ...]        # forward const slots multiplied in


@dataclasses.dataclass(frozen=True)
class Adjoint:
    """A derived adjoint operator plus its coefficient transport.

    `op` is an ordinary `StencilOp`: it runs through K1 and keys plans like
    any user operator (the gradient launches under the ``vjp`` variant).
    `map_coeffs` turns the forward canonical coefficients into the
    adjoint's.
    """

    op: StencilOp
    slots: tuple[AdjointSlot, ...]
    keep_scalars: bool              # adjoint reuses the forward scalar tuple

    def map_coeffs(self, arrays, scalars):
        """Forward canonical ``(arrays, scalars)`` -> the adjoint's.

        `arrays` is the stacked forward stream ``(..., A, z, y, x)`` (leading
        batch axes pass through), `scalars` a tuple of floats. Returns the
        adjoint streams stacked on dim -4 (None without slots) and the
        adjoint's scalar tuple.
        """
        adj_scalars = tuple(scalars) if self.keep_scalars else ()
        if not self.slots:
            return None, adj_scalars
        streams = []
        for slot in self.slots:
            w = None
            for k in slot.arrays:
                a = arrays[..., k, :, :, :]
                w = a if w is None else w * a
            factor = 1.0
            for i in slot.scalars:
                factor = factor * float(scalars[i])
            w = w * factor if factor != 1.0 else w
            streams.append(torch.roll(w, shifts=slot.shift, dims=(-3, -2, -1)))
        return torch.stack(streams, dim=-4), adj_scalars


@functools.lru_cache(maxsize=None)
def adjoint(op: StencilOp) -> Adjoint:
    """Derive the adjoint of `op`'s sweep (see the comment above).

    The adjoint op is named ``<name>.T`` (never registered); its structural
    fingerprint, equal to the reference's, keys the gradient launches'
    plans.
    """
    fold = op.scale is not None and op.scale.kind == "array"
    taps: list[Tap] = []
    slots: list[AdjointSlot] = []
    keep_scalars = False
    for t in op.taps:
        off = (-t.dz, -t.dy, -t.dx)
        if t.coeff.kind == "const" and not fold:
            taps.append(Tap(*off, const(t.coeff.index)))
            keep_scalars = True
            continue
        arrays = (t.coeff.index,) if t.coeff.kind == "array" else ()
        consts = (t.coeff.index,) if t.coeff.kind == "const" else ()
        if fold:
            arrays += (op.scale.index,)
        slots.append(AdjointSlot(t.offset, arrays, consts))
        taps.append(Tap(*off, array(len(slots) - 1)))
    scale = None
    if op.time_order == 2 and not fold:
        scale = op.scale                # a const scale carries over verbatim
        keep_scalars = keep_scalars or scale is not None
    adj_op = StencilOp(f"{op.name}.T", tuple(taps), time_order=op.time_order,
                       scale=scale, coeff_scale=op.coeff_scale)
    return Adjoint(op=adj_op, slots=tuple(slots), keep_scalars=keep_scalars)


# ---------------------------------------------------------------------------
# Coefficient packing: one canonical split everywhere
# ---------------------------------------------------------------------------

def split_coeffs(op: StencilOp, coeffs):
    """Packed (public) coefficients -> canonical ``(arrays, scalars)``.

    Scalars-only ops pass a tuple, arrays-only ops the stacked stream, mixed
    ops ``(arrays, scalars)``; a bare 3-D array is accepted for A == 1.
    Works on tensors and on numpy arrays alike.
    """
    n_arr, n_sca = op.n_coeff_arrays, op.n_scalars
    if n_arr and n_sca:
        arrays, scalars = coeffs
    elif n_arr:
        arrays, scalars = coeffs, ()
    else:
        arrays, scalars = None, coeffs
    if arrays is not None and arrays.ndim == 3:
        arrays = arrays[None]
    if arrays is not None and arrays.shape[0] != n_arr:
        raise ValueError(f"{op.name}: expected {n_arr} coefficient streams, "
                         f"got {arrays.shape[0]}")
    scalars = tuple(scalars)
    if len(scalars) != n_sca:
        raise ValueError(f"{op.name}: expected {n_sca} scalar coefficients, "
                         f"got {len(scalars)}")
    return arrays, scalars


def split_coeffs_batch(op: StencilOp, coeffs_seq):
    """Per-request packed coefficients -> ``(per-item arrays or None, scalars)``.

    Scalars are compile-time constants of a launch, so every item of a batch
    must share them; a mismatch raises.
    """
    if not coeffs_seq:
        raise ValueError(f"{op.name}: cannot stack an empty coefficient batch")
    splits = [split_coeffs(op, c) for c in coeffs_seq]
    scalars = tuple(float(x) for x in splits[0][1])
    for i, (_, sc) in enumerate(splits[1:], start=1):
        if tuple(float(x) for x in sc) != scalars:
            raise ValueError(
                f"{op.name}: batch item {i} has scalar coefficients "
                f"{tuple(float(x) for x in sc)} != item 0's {scalars}; "
                "scalars are compile-time constants, so a batch bucket must "
                "share them")
    arrays = (tuple(a for a, _ in splits) if op.n_coeff_arrays else None)
    return arrays, scalars


def join_coeffs(op: StencilOp, arrays, scalars):
    """Canonical ``(arrays, scalars)`` -> the op's packed convention."""
    if op.n_coeff_arrays and op.n_scalars:
        return (arrays, scalars)
    return arrays if op.n_coeff_arrays else tuple(scalars)


# ---------------------------------------------------------------------------
# Problems: generated from a seed, or carried across from numpy
# ---------------------------------------------------------------------------

_NUMPY = {torch.float32: np.float32, torch.float16: np.float16,
          torch.float64: np.float64}


def from_f64(x: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """float64 numpy -> `dtype` tensor, rounded as the reference rounds.

    numpy rounds f64 -> f16/f32 once (as ``jnp.asarray`` does), while torch
    goes through float32 for f16; bfloat16 has no numpy type, and torch's
    conversion agrees with the reference's there.
    """
    if dtype == torch.bfloat16:
        return torch.from_numpy(x).to(torch.bfloat16).to(device)
    return torch.from_numpy(x.astype(_NUMPY[dtype])).to(device)


def make_problem(op: StencilOp, shape, dtype=None, seed: int = 0,
                 device="cuda"):
    """Random initial state + packed coefficients for `op` on grid `shape`.

    Reproduces the reference's numpy draw order (cur, prev if 2nd order,
    then the array streams) and rounding, so a seed gives the same numbers
    in both packages. Scalars come back as a tuple of Python floats holding
    the dtype-rounded values. The draws run on the host (tens of seconds a
    grid at 768^3); `random_problem` draws the same distribution on the
    device.
    """
    dt = precision.parse_dtype(dtype)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    return _assemble(op, lambda: from_f64(
        rng.standard_normal(tuple(shape)), dt, dev), dt, dev)


def random_problem(op: StencilOp, shape, dtype=None, seed: int = 0,
                   device="cuda"):
    """A problem of `make_problem`'s distribution and layout, drawn on
    `device` by torch's generator: standard-normal grids in the stream
    dtype (drawn in float32, or float64 for f64), array streams times
    `coeff_scale`, `make_problem`'s scalars. Not the reference's numbers;
    fast at production sizes, for timing (the tuner, the sweep)."""
    dt = precision.parse_dtype(dtype)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    draw = torch.float64 if dt == torch.float64 else torch.float32
    return _assemble(op, lambda: torch.randn(
        tuple(shape), generator=gen, dtype=draw, device=dev).to(dt), dt, dev)


def _assemble(op: StencilOp, grid, dt, dev):
    """cur, prev if 2nd order, then the array streams, each one `grid()`
    draw in that order; the scaled streams and the dtype-rounded scalars
    packed as `join_coeffs` packs them."""
    cur = grid()
    prev = grid() if op.time_order == 2 else cur
    arrays = None
    if op.n_coeff_arrays:
        arrays = torch.empty((op.n_coeff_arrays,) + tuple(cur.shape),
                             dtype=dt, device=dev)
        for a in range(op.n_coeff_arrays):
            arrays[a] = grid()
        scale = from_f64(np.asarray(op.coeff_scale, np.float64), dt, "cpu")
        arrays.mul_(scale)
    svals = op.default_scalars
    if svals is None:
        svals = tuple(0.1 / (j + 1) for j in range(op.n_scalars))
    scalars = tuple(from_f64(np.asarray(svals, np.float64), dt,
                              "cpu").tolist())
    return (cur, prev), join_coeffs(op, arrays, scalars)


def _numpy_to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes arrays from the reference
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).to(
            device)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def problem_from_numpy(op: StencilOp, state, coeffs, device="cuda"):
    """Carry a ``(state, packed coeffs)`` problem given as numpy into tensors.

    `state` is ``(cur, prev)``; `coeffs` follows the op's packing convention
    (scalars only, arrays only, or ``(arrays, scalars)``). Array values keep
    their dtype bit for bit (bfloat16 included); scalars become a tuple of
    Python floats holding the exact stored values.
    """
    dev = resolve_device(device)
    cur = _numpy_to_tensor(state[0], dev)
    prev = cur if state[1] is state[0] else _numpy_to_tensor(state[1], dev)
    arrays, scalars = split_coeffs(op, coeffs)
    if arrays is not None:
        arrays = _numpy_to_tensor(arrays, dev)
    scalars = tuple(float(np.asarray(x).astype(np.float64)) for x in scalars)
    return (cur, prev), join_coeffs(op, arrays, scalars)


# ---------------------------------------------------------------------------
# The paper's four corner-case operators (Listings 1-4) as IR instances
# ---------------------------------------------------------------------------

def _off(axis: int, d: int) -> tuple[int, int, int]:
    o = [0, 0, 0]
    o[axis] = d
    return tuple(o)


_BUDGET_7PT = (("bf16", 0.03, 0.003), ("fp16", 0.004, 0.0004))
_BUDGET_25PT_2ND = (("bf16", 1.2, 0.12), ("fp16", 0.18, 0.018))
_BUDGET_25PT = (("bf16", 0.03, 0.003), ("fp16", 0.004, 0.0004))


def _paper_7pt_const() -> StencilOp:
    taps = [Tap(0, 0, 0, const(0))]
    taps += [Tap(*_off(ax, o), const(1)) for ax in range(3) for o in (-1, 1)]
    return StencilOp("7pt-const", tuple(taps), default_scalars=(0.4, 0.1),
                     error_budget=_BUDGET_7PT)


def _paper_7pt_var() -> StencilOp:
    taps = [Tap(0, 0, 0, array(0))]
    k = 1
    for ax in range(3):
        for o in (-1, 1):
            taps.append(Tap(*_off(ax, o), array(k)))
            k += 1
    return StencilOp("7pt-var", tuple(taps), coeff_scale=0.1,
                     error_budget=_BUDGET_7PT)


def _paper_25pt_const() -> StencilOp:
    taps = [Tap(0, 0, 0, const(0))]
    for d in range(1, 5):
        taps += [Tap(*_off(ax, o * d), const(d))
                 for ax in range(3) for o in (-1, 1)]
    return StencilOp("25pt-const", tuple(taps), time_order=2, scale=array(0),
                     default_scalars=(0.1, 0.06, 0.045, 0.03, 0.015),
                     coeff_scale=0.1, error_budget=_BUDGET_25PT_2ND)


def _paper_25pt_var() -> StencilOp:
    taps = [Tap(0, 0, 0, array(0))]
    for ax in range(3):
        for d in range(1, 5):
            c = array(1 + ax * 4 + (d - 1))
            taps += [Tap(*_off(ax, d), c), Tap(*_off(ax, -d), c)]
    return StencilOp("25pt-var", tuple(taps), coeff_scale=0.02,
                     error_budget=_BUDGET_25PT)


OPS: dict[str, StencilOp] = {op.name: op for op in (
    _paper_7pt_const(), _paper_7pt_var(),
    _paper_25pt_const(), _paper_25pt_var())}


# ---------------------------------------------------------------------------
# User-operator registry
# ---------------------------------------------------------------------------

_USER_OPS: dict[str, StencilOp] = {}


def register(op: StencilOp) -> StencilOp:
    """Register a user-defined operator so CLIs can resolve it by name.

    A paper operator's name cannot be taken by a structurally different op;
    re-registering an identical op is a no-op.
    """
    if not isinstance(op, StencilOp):
        raise TypeError(f"register() wants a StencilOp, got {type(op)}")
    builtin = OPS.get(op.name)
    if builtin is not None and builtin.fingerprint != op.fingerprint:
        raise ValueError(f"cannot register {op.name!r}: shadows the paper "
                         "operator of that name with different structure")
    _USER_OPS[op.name] = op
    return op


def available() -> list[str]:
    """Names resolvable by `resolve_op` (paper ops + registered user ops)."""
    return sorted({**OPS, **_USER_OPS})


def resolve_op(ref) -> StencilOp:
    """Resolve a StencilOp, a (registered) name, or ``"module.path:ATTR"``."""
    if isinstance(ref, StencilOp):
        return ref
    if ref in OPS:              # built-ins always win over registrations
        return OPS[ref]
    if ref in _USER_OPS:
        return _USER_OPS[ref]
    if ":" in str(ref):
        mod_name, attr = str(ref).split(":", 1)
        op = getattr(importlib.import_module(mod_name), attr)
        if not isinstance(op, StencilOp):
            raise TypeError(f"{ref} is not a StencilOp")
        return register(op)
    raise KeyError(f"unknown stencil {ref!r}; known: {available()} "
                   "(or pass module.path:ATTR)")
