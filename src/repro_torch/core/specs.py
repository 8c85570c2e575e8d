"""Declarative device specs: the machine model of the port, per card.

The port of `repro.core.specs`. Every analytic model of the port — the
ECM terms and roofline of `core.models`, the K1 time model and
shared-memory fit the tuner scores with, the plan registry's hardware
fingerprint — is parameterized by ONE `DeviceSpec`, declared in a JSON file
under ``src/repro_torch/specs/`` and validated against the schema below.

The schema follows Hopper, not the TPU. Where the reference has one VMEM
size and rate, a CUDA card has a per-block shared-memory limit, a per-SM
pool, an L2 and SMs grouped into thread-block clusters; and two costs that
bound K1 besides bytes are measured on the card: one kernel launch
(`launch_s`) and one cluster barrier (`cluster_barrier_s`); K1's time
model prices its barrier-ended phases at costs fitted to measured K1 times
(`k1_phase_s`, `k1_cta_phase_s`, `k1_row_load_s`: `models.fit_k1`). The
energy model's constants (`static_power_w`, `joules_per_flop`,
`joules_per_hbm_byte`), which no data sheet gives, are measured too. The
interconnect (`ici_bw_per_link`, `ici_links`: NVLink, the reference's
field names) prices the dry-run's collective term. The
file's `source` string names where each figure comes from (a data sheet, or the
card's name and power limit as ``nvidia-smi`` reports them).

Resolution (`get_spec`) accepts a committed spec name ("h100-sxm"), a path
to a spec file, or None for the process default: ``$REPRO_TORCH_DEVICE_SPEC``
when set, else the ``--spec`` flag of the launch CLIs (`set_default_spec`),
else "h100-sxm".

The derived ``latency_bytes = hbm_bw * launch_s`` is the launch-cost
crossover: a launch moving fewer HBM bytes than this cannot be
bandwidth-bound, because streaming them takes less time than the launch.
`models.ecm_predict` and `models.roofline` then report a "latency" term.

`fingerprint` (the registry invalidation key) hashes the resolved spec's
constants and the torch runtime (torch and CUDA versions, device name and
count, or ``cpu``), memoized per (spec, process).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os


class SpecError(ValueError):
    """A device spec file failed schema validation or could not be found."""


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Per-card hardware constants driving every analytic model."""

    name: str
    source: str                 # where the figures come from
    peak_flops_bf16: float      # dense tensor-core peak, FLOP/s
    peak_flops_f32: float       # f32 peak outside the tensor cores, FLOP/s
    hbm_bw: float               # device memory B/s
    ici_bw_per_link: float      # B/s per interconnect (NVLink) link, both
                                # directions
    ici_links: int              # interconnect links per card
    smem_bw: float              # shared memory B/s, all SMs together
    l2_bytes: int               # L2 cache
    smem_block_bytes: int       # dynamic shared memory one block may opt into
    smem_sm_bytes: int          # shared memory of one SM
    n_sm: int                   # streaming multiprocessors
    n_gpc: int                  # GPCs: a thread-block cluster keeps to one
    threads_sm: int             # resident threads per SM
    regs_sm: int                # 32-bit registers per SM
    max_cluster: int            # CTAs in the largest thread-block cluster
    launch_s: float             # one kernel launch, measured
    cluster_barrier_s: float    # one cluster barrier alone, measured
    # K1's phase costs (`models.K1_COSTS`), fitted to measured K1 times
    k1_phase_s: float           # a phase ended by a cluster barrier
    k1_cta_phase_s: float       # a phase ended by a block barrier
    k1_row_load_s: float        # per load of a row on a phase's busiest warp
    # Energy model constants (Fig. 19 analog), measured on the card
    static_power_w: float       # idle draw with a live context, W
    joules_per_flop: float      # incremental f32 core energy
    joules_per_hbm_byte: float  # incremental device-memory energy

    @property
    def latency_bytes(self) -> float:
        """Traffic below which a launch is latency- not bandwidth-bound.

        Derived, never declared: ``hbm_bw * launch_s``, the bytes the memory
        system streams during one kernel launch.
        """
        return self.hbm_bw * self.launch_s

    def to_dict(self) -> dict:
        """Declared fields only (derived properties are never serialized)."""
        return dataclasses.asdict(self)


# Schema: field -> type. `name` and `source` are checked separately; every
# numeric field must be > 0.
_SCHEMA: dict[str, type] = {
    "peak_flops_bf16": float,
    "peak_flops_f32": float,
    "hbm_bw": float,
    "ici_bw_per_link": float,
    "ici_links": int,
    "smem_bw": float,
    "l2_bytes": int,
    "smem_block_bytes": int,
    "smem_sm_bytes": int,
    "n_sm": int,
    "n_gpc": int,
    "threads_sm": int,
    "regs_sm": int,
    "max_cluster": int,
    "launch_s": float,
    "cluster_barrier_s": float,
    "k1_phase_s": float,
    "k1_cta_phase_s": float,
    "k1_row_load_s": float,
    "static_power_w": float,
    "joules_per_flop": float,
    "joules_per_hbm_byte": float,
}
_STRINGS = ("name", "source")

ENV_SPEC = "REPRO_TORCH_DEVICE_SPEC"
ENV_SPEC_DIR = "REPRO_TORCH_SPEC_DIR"
DEFAULT_SPEC_NAME = "h100-sxm"


def validate_spec_dict(raw: dict, *, origin: str = "<dict>") -> dict:
    """Schema-check one spec dict; returns the coerced field map.

    Rejects (with a `SpecError` naming the field and file): a missing or
    empty `name` or `source`, missing fields, unknown fields, non-numeric
    values and values that are not > 0. ``latency_bytes`` is derived and
    therefore rejected if declared.
    """
    if not isinstance(raw, dict):
        raise SpecError(f"{origin}: spec must be a JSON object, "
                        f"got {type(raw).__name__}")
    for field in _STRINGS:
        v = raw.get(field)
        if not isinstance(v, str) or not v:
            raise SpecError(f"{origin}: missing or empty '{field}'")
    unknown = set(raw) - set(_SCHEMA) - set(_STRINGS)
    if unknown:
        hint = (" ('latency_bytes' is derived from hbm_bw and launch_s — "
                "do not declare it)" if "latency_bytes" in unknown else "")
        raise SpecError(f"{origin}: unknown field(s) "
                        f"{sorted(unknown)}{hint}")
    missing = set(_SCHEMA) - set(raw)
    if missing:
        raise SpecError(f"{origin}: missing field(s) {sorted(missing)}")
    out: dict = {f: raw[f] for f in _STRINGS}
    for field, typ in _SCHEMA.items():
        v = raw[field]
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise SpecError(f"{origin}: field '{field}' must be a number, "
                            f"got {v!r}")
        if not v > 0:
            raise SpecError(f"{origin}: field '{field}' must be > 0, "
                            f"got {v!r}")
        if typ is int and v != int(v):
            raise SpecError(f"{origin}: field '{field}' must be an integer, "
                            f"got {v!r}")
        out[field] = typ(v)
    return out


def spec_dirs() -> list[str]:
    """Directories searched for ``<name>.json`` spec files.

    ``$REPRO_TORCH_SPEC_DIR`` first, then the port's own ``specs/`` beside
    its ``core/`` package. The reference's ``specs/`` is never searched.
    """
    dirs = []
    env = os.environ.get(ENV_SPEC_DIR)
    if env:
        dirs.append(env)
    here = os.path.dirname(os.path.abspath(__file__))
    dirs.append(os.path.join(os.path.dirname(here), "specs"))
    return dirs


def _resolve_path(name_or_path: str) -> str:
    if os.sep in name_or_path or name_or_path.endswith(".json"):
        if os.path.exists(name_or_path):
            return name_or_path
        raise SpecError(f"device spec file not found: {name_or_path}")
    for d in spec_dirs():
        cand = os.path.join(d, f"{name_or_path}.json")
        if os.path.exists(cand):
            return cand
    raise SpecError(
        f"unknown device spec '{name_or_path}': no {name_or_path}.json in "
        f"{spec_dirs()} (set ${ENV_SPEC_DIR} or pass a file path)")


def load_spec_file(path: str) -> DeviceSpec:
    """Parse + schema-validate one spec file into a `DeviceSpec`."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except OSError as e:
        raise SpecError(f"cannot read device spec {path}: {e}") from e
    except ValueError as e:
        raise SpecError(f"device spec {path} is not valid JSON: {e}") from e
    return DeviceSpec(**validate_spec_dict(raw, origin=path))


# get_spec memo: (resolved path, mtime_ns) -> DeviceSpec; an edited file
# reloads (and, through the fingerprint, invalidates its tuned plans)
_SPECS: dict[tuple[str, int], DeviceSpec] = {}
_default_override: str | None = None


def get_spec(name_or_path: str | None = None) -> DeviceSpec:
    """Resolve a device spec by committed name, file path, or default.

    `None` resolves the process default: ``$REPRO_TORCH_DEVICE_SPEC``, then
    the ``--spec`` override (`set_default_spec`), then "h100-sxm". Parsed
    specs are memoized per (path, mtime).
    """
    if name_or_path is None:
        name_or_path = (os.environ.get(ENV_SPEC) or _default_override
                        or DEFAULT_SPEC_NAME)
    path = _resolve_path(name_or_path)
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError as e:
        raise SpecError(f"cannot stat device spec {path}: {e}") from e
    key = (os.path.abspath(path), mtime)
    if key not in _SPECS:
        _SPECS[key] = load_spec_file(path)
    return _SPECS[key]


def set_default_spec(name_or_path: str | None) -> DeviceSpec:
    """Set (or with None, clear) the process-default spec; returns it.

    The launch CLIs call this from their ``--spec`` flag before any model
    or registry code runs. ``$REPRO_TORCH_DEVICE_SPEC`` still wins.
    """
    global _default_override
    if name_or_path is not None:
        get_spec(name_or_path)          # validate before committing to it
    _default_override = name_or_path
    return get_spec()


def current_spec() -> DeviceSpec:
    """The process-default `DeviceSpec` (see `get_spec(None)`)."""
    return get_spec(None)


# ---------------------------------------------------------------------------
# Hardware fingerprint (registry invalidation key), memoized per spec
# ---------------------------------------------------------------------------

_TORCH_ENV: list[str] | None = None
_FINGERPRINTS: dict[DeviceSpec, str] = {}


def _torch_env() -> list[str]:
    # torch/CUDA versions and the visible cards are process constants
    global _TORCH_ENV
    if _TORCH_ENV is None:
        import torch

        if torch.cuda.is_available():
            devices = [torch.cuda.get_device_name(0),
                       str(torch.cuda.device_count())]
        else:
            devices = ["cpu"]
        _TORCH_ENV = [torch.__version__, str(torch.version.cuda)] + devices
    return _TORCH_ENV


def fingerprint(spec: DeviceSpec | None = None) -> str:
    """Stable hash of (resolved device spec, torch runtime) — memoized.

    The tuned-plan registry keys its entries by this value: a change to any
    spec constant or to the runtime (torch or CUDA version, device name or
    count) yields another fingerprint, so plans tuned elsewhere are not
    replayed.
    """
    spec = spec or current_spec()
    fp = _FINGERPRINTS.get(spec)
    if fp is None:
        parts = _torch_env() + [spec.name] + [
            f"{getattr(spec, f):.6e}" if typ is float
            else str(getattr(spec, f)) for f, typ in _SCHEMA.items()]
        fp = hashlib.sha1("|".join(parts).encode()).hexdigest()[:16]
        _FINGERPRINTS[spec] = fp
    return fp


# ---------------------------------------------------------------------------
# CLI: schema-validate spec files
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    """Validate spec files: ``python -m repro_torch.core.specs [files...]``.

    With no arguments, validates every ``*.json`` in the first spec
    directory that has any. Prints one line per spec and returns nonzero if
    any file fails the schema.
    """
    import argparse
    import glob as _glob

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.specs",
        description="Schema-validate the port's device spec files")
    ap.add_argument("files", nargs="*",
                    help="spec files (default: every src/repro_torch/specs/"
                         "*.json)")
    args = ap.parse_args(argv)
    files = args.files
    if not files:
        for d in spec_dirs():
            files = sorted(_glob.glob(os.path.join(d, "*.json")))
            if files:
                break
    if not files:
        print("no spec files found")
        return 1
    status = 0
    for path in files:
        try:
            spec = load_spec_file(path)
        except SpecError as e:
            print(f"FAIL {path}: {e}")
            status = 1
            continue
        print(f"ok   {path}: {spec.name} hbm_bw={spec.hbm_bw:.3e} B/s "
              f"latency_bytes={spec.latency_bytes:.1f}")
    return status


if __name__ == "__main__":
    raise SystemExit(main())
