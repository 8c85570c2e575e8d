"""Persistent tuned-plan registry: measured tuning results, cached on disk.

The port of `repro.core.registry` (and of `repro.compat.translate_entry`).
Tune once per (stencil, grid, hardware), then every later run —
`ops.mwd(plan="auto")`, the serving loop — resolves the stored plan and
performs zero measurements.

Registry layout (one JSON file, the reference's schema):

    {"version": 1,
     "plans": {"<stencil>@<ir fp>|<nz>x<ny>x<nx>|w<word>|dx<dx>|b<batch>": {
         "plan": {"d_w": 16, "n_f": 2, "tg_x": 1, "fused": true, ...},
         "score": 12.3, "source": "measured", "evals": 14,
         "spec": "h100-sxm",
         "fingerprint": "<specs.fingerprint() at tune time>"}}}

Keys are byte-identical to the reference's for the same problem. Entries
record the device-spec name and fingerprint they were tuned under. A
lookup whose fingerprint differs is stale when the spec is the same (it is
dropped on the next save) and foreign when the spec differs: foreign
entries are kept and offered to `translate_entry`, which revalidates the
plan under the current spec and rescales its score by the ratio of model
scores. Legacy name-only keys are dropped at load, and keys without the
``b<B>`` segment are read as ``b1``. Misses fall back to the model-scored
tuner (`autotune.autotune`), memoized per process, never persisted.

The file is the port's own: ``$REPRO_TORCH_PLAN_REGISTRY`` when set, else
``.repro_torch_cache/plans.json`` under the current directory (git-ignored).
The reference's ``.repro_cache/plans.json`` is never read or written.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile

from repro_torch.core import specs as devspecs
from repro_torch.core.mwd import MWDPlan
from repro_torch.core.stencils import StencilSpec

SCHEMA_VERSION = 1
ENV_VAR = "REPRO_TORCH_PLAN_REGISTRY"
DEFAULT_PATH = os.path.join(".repro_torch_cache", "plans.json")


def default_grid(spec: StencilSpec) -> tuple[int, int, int]:
    """Sanity-scale default tuning grid per stencil (the reference's).

    Small enough for the CPU's plain versions; on the card pass production
    grids instead.
    """
    return (10, 18, 14) if spec.radius == 1 else (12, 26, 18)


VARIANTS = ("", "vjp")


def plan_key(spec: StencilSpec, grid_shape, word_bytes: int = 4,
             devices_x: int = 1, batch: int = 1,
             variant: str = "") -> str:
    """Registry key of one tuning problem (hw fingerprint lives in the entry).

    The stencil segment is ``name@<structural fingerprint>`` so two
    user-defined operators sharing a display name can never collide in the
    cache.  Only `StencilOp`s are accepted: a bare name would produce the
    legacy fingerprint-less key that `_load` discards, silently losing the
    entry on the next start.

    The trailing ``b<B>`` segment is the batch axis of the batched serving
    launch (`ops.mwd_batched`): a plan tuned for ONE grid is not the plan
    for B resident grids (the dispatch amortization shifts the optimum), so
    batched entries must never collide with B=1 entries.  Legacy keys
    without the segment are upgraded to ``b1`` at load (`_load`).

    `variant` distinguishes derived launches of the same operator that
    want their own tuned plan: gradient (backward) launches resolve under
    ``variant="vjp"``, appending a trailing ``|vjp`` segment, so a tuned
    adjoint plan never collides with the forward entry even when a future
    caller keys both on the same op.  The empty variant (forward) appends
    nothing, keeping every pre-existing key byte-identical.
    """
    if isinstance(spec, str):
        raise TypeError("plan_key needs a StencilOp (a bare name has no "
                        "structural fingerprint); resolve it via "
                        "repro_torch.core.ir.resolve_op first")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if variant not in VARIANTS:
        raise ValueError(f"unknown plan variant {variant!r}; "
                         f"known: {[v for v in VARIANTS if v]}")
    nz, ny, nx = grid_shape
    key = f"{spec.name}@{spec.fingerprint}|{nz}x{ny}x{nx}|w{word_bytes}" \
          f"|dx{devices_x}|b{batch}"
    return f"{key}|{variant}" if variant else key


@dataclasses.dataclass(frozen=True)
class RegistryEntry:
    """One tuned plan plus the provenance needed to trust or invalidate it."""

    plan: MWDPlan
    score: float               # GLUP/s under `source`'s scorer
    source: str                # "measured", "model" or "translated:<spec>"
    fingerprint: str           # specs.fingerprint() at tune time
    evals: int = 0             # plans the search evaluated
    spec: str = ""             # device-spec name at tune time ("" = legacy)

    def to_dict(self) -> dict:
        """JSON-serializable form (inverse of `from_dict`)."""
        return {"plan": dataclasses.asdict(self.plan), "score": self.score,
                "source": self.source, "fingerprint": self.fingerprint,
                "evals": self.evals, "spec": self.spec}

    @classmethod
    def from_dict(cls, d: dict) -> "RegistryEntry":
        """Rebuild an entry from its JSON form, sanitized.

        Raises on unknown/garbage fields (the caller drops the entry); a
        kernel-invalid but well-formed plan is clamped by `_sanitize`, so a
        hand-edited registry file cannot crash a launch. A missing ``spec``
        field (pre-spec schema) loads as "" and is treated like a same-spec
        entry for staleness purposes.
        """
        return cls(plan=_sanitize(MWDPlan(**d["plan"])),
                   score=float(d["score"]), source=str(d["source"]),
                   fingerprint=str(d["fingerprint"]),
                   evals=int(d.get("evals", 0)),
                   spec=str(d.get("spec", "")))


def _sanitize(plan: MWDPlan) -> MWDPlan:
    """Clamp a plan to what the MWD kernel accepts (n_f must divide d_w).

    Raises ValueError for plans no clamping can save (d_w < 1).
    """
    if plan.d_w < 1:
        raise ValueError(f"unusable plan: d_w={plan.d_w}")
    n_f = min(max(plan.n_f, 1), plan.d_w)
    while plan.d_w % n_f:
        n_f -= 1
    return plan if n_f == plan.n_f else dataclasses.replace(plan, n_f=n_f)


class PlanRegistry:
    """Disk-backed map from tuning problems to tuned `MWDPlan`s.

    Loads eagerly, writes atomically (tmp file + rename), and drops stale
    entries (fingerprint mismatch) at lookup/save time. A corrupt or
    version-mismatched file is treated as empty rather than fatal: the
    registry is a cache, never a source of truth.
    """

    def __init__(self, path: str | None = None):
        """Open (or lazily create) the registry file at `path`.

        `path=None` resolves `$REPRO_TORCH_PLAN_REGISTRY`, falling back to
        `.repro_torch_cache/plans.json`.
        """
        self.path = path or os.environ.get(ENV_VAR) or DEFAULT_PATH
        self._entries: dict[str, RegistryEntry] = {}
        self._memo: dict[str, tuple[MWDPlan, str]] = {}  # model fallbacks
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                raw = json.load(f)
            if raw.get("version") != SCHEMA_VERSION:
                return
            plans = raw.get("plans", {})
        except (OSError, ValueError, AttributeError):
            return
        for key, d in plans.items():
            if "@" not in key.split("|", 1)[0]:
                continue            # legacy name-only key (pre-IR schema):
                                    # no fingerprint -> silently invalidated
            parts = key.split("|")
            variant = parts.pop() if parts[-1] in VARIANTS[1:] else ""
            if not (parts[-1].startswith("b") and parts[-1][1:].isdigit()):
                parts.append("b1")  # pre-batch schema: a key without the
                                    # b<B> segment is a single-grid plan
            key = "|".join(parts + ([variant] if variant else []))
            try:
                self._entries[key] = RegistryEntry.from_dict(d)
            except (ValueError, KeyError, TypeError):
                continue            # one bad entry must not poison the rest

    def save(self) -> None:
        """Atomically persist all non-stale entries to `self.path`.

        Stale means: fingerprint mismatch under the SAME spec (or a legacy
        entry with no recorded spec). Entries tuned under a different spec
        are foreign, not stale — they are kept so `resolve` can translate
        them under the current spec.
        """
        fp = devspecs.fingerprint()
        name = devspecs.current_spec().name
        live = {k: e for k, e in self._entries.items()
                if e.fingerprint == fp or (e.spec and e.spec != name)}
        payload = {"version": SCHEMA_VERSION,
                   "plans": {k: e.to_dict() for k, e in live.items()}}
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            os.unlink(tmp)
            raise

    def __len__(self) -> int:
        """Number of entries currently held (including stale ones)."""
        return len(self._entries)

    def stats(self) -> dict:
        """Entry counts by provenance: total, measured, model, stale, foreign.

        "stale" counts same-spec entries recorded under a fingerprint other
        than the current one (pruned at the next save); "foreign" counts
        entries tuned under a different device spec (kept as translation
        sources). "spec" names the active device spec the counts were taken
        under.
        """
        fp = devspecs.fingerprint()
        name = devspecs.current_spec().name
        stale = foreign = 0
        by_source: dict[str, int] = {}
        for e in self._entries.values():
            if e.fingerprint == fp:
                by_source[e.source] = by_source.get(e.source, 0) + 1
            elif e.spec and e.spec != name:
                foreign += 1
            else:
                stale += 1
        return {"total": len(self._entries), "stale": stale,
                "foreign": foreign, "spec": name,
                "measured": by_source.get("measured", 0),
                "model": by_source.get("model", 0)}

    def get(self, spec: StencilSpec, grid_shape, word_bytes: int = 4,
            devices_x: int = 1, batch: int = 1,
            fingerprint: str | None = None,
            variant: str = "") -> RegistryEntry | None:
        """Cached entry for the problem, or None on miss / stale fingerprint.

        A stale entry (recorded fingerprint != the current one) is removed
        from the in-memory map so the next `save()` prunes it from disk.
        """
        key = plan_key(spec, grid_shape, word_bytes, devices_x, batch,
                       variant)
        entry = self._entries.get(key)
        if entry is None:
            return None
        fingerprint = fingerprint or devspecs.fingerprint()
        if entry.fingerprint != fingerprint:
            if entry.spec and entry.spec != devspecs.current_spec().name:
                return None             # foreign spec: kept for translation
            del self._entries[key]      # stale: tuned on different hardware
            return None
        if entry.plan.d_w % (2 * spec.radius):
            del self._entries[key]      # geometry invalid for this stencil
            return None
        return entry

    def put(self, spec: StencilSpec, grid_shape, plan: MWDPlan,
            score: float, *, source: str = "measured", evals: int = 0,
            word_bytes: int = 4, devices_x: int = 1, batch: int = 1,
            fingerprint: str | None = None, variant: str = "",
            persist: bool = True) -> RegistryEntry:
        """Record a tuned plan and (by default) write the file through.

        The entry records the active device-spec name alongside the
        fingerprint, which is what later lets a different-spec process
        recognize it as translatable rather than stale.
        """
        entry = RegistryEntry(plan=_sanitize(plan), score=score,
                              source=source,
                              fingerprint=fingerprint or devspecs.fingerprint(),
                              evals=evals,
                              spec=devspecs.current_spec().name)
        self._entries[plan_key(spec, grid_shape, word_bytes,
                               devices_x, batch, variant)] = entry
        if persist:
            self.save()
        return entry

    def foreign_entry(self, spec: StencilSpec, grid_shape,
                      word_bytes: int = 4, devices_x: int = 1,
                      batch: int = 1, variant: str = "") -> RegistryEntry | None:
        """The stored entry for this problem tuned under a DIFFERENT spec.

        Returns None when the key is absent or the stored entry belongs to
        the current spec (then `get` is the right accessor). The entry is
        the raw foreign record — callers translate it via
        `translate_entry` before trusting plan or score.
        """
        key = plan_key(spec, grid_shape, word_bytes, devices_x, batch,
                       variant)
        entry = self._entries.get(key)
        if entry is None or not entry.spec:
            return None
        if entry.spec == devspecs.current_spec().name:
            return None
        return entry

    def resolve(self, spec: StencilSpec, grid_shape, word_bytes: int = 4,
                devices_x: int = 1, batch: int = 1,
                chip: devspecs.DeviceSpec | None = None,
                variant: str = "") -> tuple[MWDPlan, str]:
        """Plan for the problem: registry-first, translated, model fallback.

        Returns `(plan, source)`; source is "registry:measured" or
        "registry:model" on a cache hit (echoing how the entry was tuned),
        "translated:<spec>" when a plan tuned under a different device spec
        was revalidated and rescaled for this one (zero re-measurement; see
        `translate_entry`), and "model" for the model-scored fallback.
        Translated and model resolutions are memoized per process but never
        persisted — run `python -m repro_torch.launch.tune` to tune and
        persist native entries.

        `batch` > 1 resolves under the batched ``b<B>`` key and scores the
        fallback with the batch-amortized launch model (`models`/
        `autotune`), so a batched serving bucket gets a plan for ONE
        launch advancing B grids rather than the B=1 optimum.
        """
        chip = chip or devspecs.current_spec()
        entry = self.get(spec, grid_shape, word_bytes, devices_x, batch,
                         variant=variant)
        if entry is not None:
            return entry.plan, f"registry:{entry.source}"
        key = plan_key(spec, grid_shape, word_bytes, devices_x, batch,
                       variant)
        if key not in self._memo:
            foreign = self.foreign_entry(spec, grid_shape, word_bytes,
                                         devices_x, batch, variant)
            if foreign is not None:
                translated = translate_entry(
                    foreign, spec, grid_shape, to_spec=chip,
                    word_bytes=word_bytes, batch=batch)
                if translated is not None:
                    self._memo[key] = (translated.plan, translated.source)
                    return self._memo[key]
            from repro_torch.core import autotune
            # cap D_w at the y extent: a diamond wider than the domain only
            # inflates the launch padding, never the score
            res = autotune.autotune(spec, grid_shape, devices_x=devices_x,
                                    chip=chip, word_bytes=word_bytes,
                                    d_w_cap=grid_shape[1], batch=batch)
            self._memo[key] = (_sanitize(res.plan), "model")
        return self._memo[key]


_REGISTRIES: dict[str, PlanRegistry] = {}


def default_registry() -> PlanRegistry:
    """Process-wide registry at the default path (one instance per path).

    The path is re-resolved on every call so tests (and multi-tenant
    drivers) can repoint `$REPRO_TORCH_PLAN_REGISTRY` mid-process.
    """
    path = os.environ.get(ENV_VAR) or DEFAULT_PATH
    if path not in _REGISTRIES:
        _REGISTRIES[path] = PlanRegistry(path)
    return _REGISTRIES[path]


def resolve_plan(spec: StencilSpec, grid_shape, word_bytes: int = 4,
                 devices_x: int = 1, batch: int = 1,
                 chip: devspecs.DeviceSpec | None = None,
                 variant: str = "") -> tuple[MWDPlan, str]:
    """Module-level convenience: `default_registry().resolve(...)`."""
    return default_registry().resolve(spec, grid_shape, word_bytes,
                                      devices_x, batch, chip, variant)


def translate_entry(entry: RegistryEntry, op: StencilSpec, grid_shape, *,
                    to_spec: devspecs.DeviceSpec, word_bytes: int = 4,
                    batch: int = 1) -> RegistryEntry | None:
    """Translate a registry entry tuned under another spec to `to_spec`.

    The reference's policy (`repro.compat.translate_entry`):

      1. refuse (None) when the entry names no spec or `to_spec` itself, an
         unknown spec, a plan the kernel refuses for the op, a plan whose
         rings do not fit K1 under `to_spec` (`models.smem_fits`), or when
         either model score is non-finite or non-positive;
      2. otherwise rescale: score_B = score_A * model_B(plan)/model_A(plan).
         Nothing is measured.

    The result carries ``source="translated:<spec A>"`` and the target
    spec's name and fingerprint.
    """
    from repro_torch.core import autotune, models

    if not entry.spec or entry.spec == to_spec.name:
        return None                       # nothing to translate
    try:
        from_spec = devspecs.get_spec(entry.spec)
    except devspecs.SpecError:
        return None                       # unknown source spec: refuse
    plan = entry.plan
    if not autotune._plan_valid(op, plan):
        return None
    if not models.smem_fits(op, plan.d_w, plan.n_f, grid_shape[2],
                            word_bytes, to_spec):
        return None
    score_a = autotune.model_score(op, grid_shape, word_bytes, from_spec,
                                   batch)(plan)
    score_b = autotune.model_score(op, grid_shape, word_bytes, to_spec,
                                   batch)(plan)
    if not (math.isfinite(score_a) and math.isfinite(score_b)
            and score_a > 0.0 and score_b > 0.0):
        return None
    return dataclasses.replace(
        entry,
        score=entry.score * (score_b / score_a),
        source=f"translated:{entry.spec}",
        fingerprint=devspecs.fingerprint(to_spec),
        spec=to_spec.name,
    )
