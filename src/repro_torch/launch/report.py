"""Render the port's performance study from its sweep results.

The port of `benchmarks/experiments.py`: `repro_torch.launch.sweep`
records measured and model points into versioned JSON under
``src/repro_torch/results/``; this module turns them into the paper-style
tables (GLUP/s vs grid size, Figs. 8-15; B/LUP vs grid size, Fig. 4; bf16
against f32; the energy split, Fig. 19; the model against the
measurement, Sec. 7, for the ECM fit and for K1's phase fit; the
distributed leg, the strong/weak scaling ladder and the overlap model's
residuals, Sec. 4.2) and writes ``src/repro_torch/results/REPRODUCTION.md``.
Its provenance names the card and power limit every point ran on, and the
distributed sections say how many cards their shards shared. The dry-run
and roofline sections wait for the LM substrate (ROADMAP.md item 13).

``--check`` re-renders from the committed results and fails (exit 2) when
the committed report drifts.

  python -m repro_torch.launch.report            # render
  python -m repro_torch.launch.report --check    # fail on drift
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.core import models
from repro_torch.launch.sweep import RESULTS_DIR

DEFAULT_OUT = os.path.join(RESULTS_DIR, "REPRODUCTION.md")
MODEL_LABEL = "H100 model"        # the a-priori model's column name


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

def load_sweeps(results_dir: str = RESULTS_DIR) -> dict:
    """Merge every ``sweep*.json`` in `results_dir` into one point map.

    Later files (lexicographic) win on key collisions, so the render is
    deterministic.
    """
    merged: dict = {"points": {}, "files": [], "fingerprints": set(),
                    "specs": set(), "devices": set()}
    for path in sorted(glob.glob(os.path.join(results_dir, "sweep*.json"))):
        try:
            with open(path) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            continue
        merged["files"].append(os.path.basename(path))
        merged["points"].update(raw.get("points", {}))
        for p in raw.get("points", {}).values():
            merged["fingerprints"].add(p.get("hw_fingerprint", "?"))
            merged["specs"].add(p.get("spec") or "(unrecorded)")
            dev = p.get("device") or {}
            merged["devices"].add(f"{dev.get('name', '?')}, power limit "
                                  f"{dev.get('power_limit') or 'n/a'}")
    for k in ("fingerprints", "specs", "devices"):
        merged[k] = sorted(merged[k])
    return merged


def _grid_str(p: dict) -> str:
    return "x".join(str(n) for n in p["grid"])


def _plan_str(p: dict) -> str:
    pl = p["plan"]
    if pl is None:          # plain-route points (the scaling legs)
        return "-"
    return f"dw{pl['d_w']}.nf{pl['n_f']}" + ("" if pl["fused"] else ".row")


def _sorted_points(points: dict) -> list[dict]:
    return [points[k] for k in sorted(points)]


def _by_stencil(pts: list[dict]) -> dict[str, list[dict]]:
    out: dict[str, list[dict]] = {}
    for p in pts:
        out.setdefault(p["stencil"], []).append(p)
    for v in out.values():
        v.sort(key=lambda p: (tuple(p["grid"]), p["mode"], p["batch"]))
    return out


# ---------------------------------------------------------------------------
# Tables (the reference's, with the H100 model's label)
# ---------------------------------------------------------------------------

def glups_table(pts: list[dict], calib: models.EcmCalibration | None) -> str:
    """Measured vs modeled throughput per (grid, mode, batch) row."""
    rows = [f"| grid | mode | B | plan | measured GLUP/s | {MODEL_LABEL} "
            "GLUP/s | calibrated GLUP/s | residual |",
            "|---|---|---|---|---|---|---|---|"]
    for p in pts:
        meas = p["measured"]
        cal = res = "-"
        if calib is not None:
            t_cal = calib.predict_s(p["flops"], p["traffic"]["hbm_bytes"])
            cal = f"{p['lups'] / t_cal / 1e9:.5f}"
            res = f"{(t_cal - meas['t_s']) / meas['t_s']:+.0%}"
        rows.append(
            f"| {_grid_str(p)} | {p['mode']} | {p['batch']} | {_plan_str(p)} "
            f"| {meas['glups']:.5f} | {p['model']['glups']:.2f} "
            f"| {cal} | {res} |")
    return "\n".join(rows)


def ecm_table(pts: list[dict]) -> str:
    """Per-point ECM term breakdown with the binding term named."""
    rows = ["| grid | mode | B | HBM bytes | latency bytes | t_hbm | "
            "t_compute | t_smem | t_latency | dominant |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for p in pts:
        ecm = p["model"]["ecm"]
        rows.append(
            f"| {_grid_str(p)} | {p['mode']} | {p['batch']} "
            f"| {p['traffic']['hbm_bytes']:.2e} | {ecm['latency_bytes']:.2e} "
            f"| {ecm['t_hbm']:.2e} | {ecm['t_compute']:.2e} "
            f"| {ecm['t_smem']:.2e} | {ecm['t_latency']:.2e} "
            f"| **{ecm['dominant']}** |")
    return "\n".join(rows)


def blup_table(pts: list[dict]) -> str:
    """Eq. 5 model vs K1's own code balance per row."""
    rows = ["| grid | mode | D_w | Eq.5 model B/LUP | exact kernel B/LUP "
            "| spatial B/LUP | vs spatial |",
            "|---|---|---|---|---|---|---|"]
    for p in pts:
        if p["batch"] != 1 or p.get("distributed"):
            continue
        bk = p["traffic"]["b_per_lup"]
        bs = p["model"]["bc_spatial"]
        rows.append(
            f"| {_grid_str(p)} | {p['mode']} | {p['plan']['d_w']} "
            f"| {p['model']['bc_eq5']:.2f} | {bk:.2f} | {bs:.2f} "
            f"| {1 - bk / bs:+.0%} |")
    return "\n".join(rows)


def energy_table(pts: list[dict]) -> str:
    """Fig. 19 analog: the modeled energy split per tuning choice."""
    rows = ["| grid | mode | B/LUP | core J | HBM J | static J | total J "
            "| pJ/LUP |",
            "|---|---|---|---|---|---|---|---|"]
    for p in pts:
        if p["batch"] != 1 or p.get("distributed"):
            continue
        e = p["model"]["energy_j"]
        rows.append(
            f"| {_grid_str(p)} | {p['mode']} | {p['traffic']['b_per_lup']:.2f} "
            f"| {e['core']:.2e} | {e['hbm']:.2e} | {e['static']:.2e} "
            f"| {e['total']:.2e} | {e['total'] / p['lups'] * 1e12:.1f} |")
    return "\n".join(rows)


def residual_table(report: dict) -> str:
    """Per-point calibrated-vs-measured overlay rows (keys' ``|`` escaped
    so they do not split a table cell)."""
    rows = ["| point | measured s | calibrated s | residual |",
            "|---|---|---|---|"]
    for e in report["per_point"]:
        key = e["key"].replace("|", "\\|")
        rows.append(f"| `{key}` | {e['measured_s']:.4f} "
                    f"| {e['calibrated_s']:.4f} | {e['rel_err']:+.0%} |")
    return "\n".join(rows)


def dtype_table(pts: list[dict]) -> str:
    """Reduced-precision vs f32 rows (same grid, fused, B=1); `vs f32` is
    K1's B/LUP ratio, which the precision gate holds at <= 0.6x."""
    by: dict[tuple, dict] = {}
    for p in pts:
        if p["batch"] != 1 or p.get("distributed") or p["mode"] != "fused":
            continue
        by[(p["stencil"], tuple(p["grid"]), p.get("dtype", "f32"))] = p
    rows = ["| stencil | grid | dtype | plan | exact B/LUP | vs f32 "
            "| measured GLUP/s |",
            "|---|---|---|---|---|---|---|"]
    for (stencil, grid, dt), p in sorted(by.items()):
        if dt == "f32":
            continue
        base = by.get((stencil, grid, "f32"))
        for q in (base, p):
            if q is None:
                continue
            bk = q["traffic"]["b_per_lup"]
            ratio = ("-" if base is None or q is base
                     else f"{bk / base['traffic']['b_per_lup']:.2f}x")
            rows.append(
                f"| {stencil} | {_grid_str(q)} | {q.get('dtype', 'f32')} "
                f"| {_plan_str(q)} | {bk:.2f} | {ratio} "
                f"| {q['measured']['glups']:.5f} |")
    return "\n".join(rows)


def k1_fit_points(pts: list[dict]) -> list[dict]:
    """`models.fit_k1` inputs of the points that timed K1 alone."""
    return [models.k1_fit_point(p["key"], p["model"]["k1"],
                                p["measured"]["k1_t_s"])
            for p in pts if "k1_t_s" in p["measured"]]


def k1_residual_table(report: dict) -> str:
    """K1 alone: measured, the committed spec's K1 model, and the model
    refitted over these points (`models.fit_k1`)."""
    rows = ["| point | K1 measured s | spec model s | refitted s "
            "| residual |",
            "|---|---|---|---|---|"]
    for e in report["per_point"]:
        key = e["key"].replace("|", "\\|")
        rows.append(f"| `{key}` | {e['measured_s']:.4f} "
                    f"| {e['model_s']:.4f} | {e['calibrated_s']:.4f} "
                    f"| {e['rel_err']:+.0%} |")
    return "\n".join(rows)


# ---------------------------------------------------------------------------
# The report
# ---------------------------------------------------------------------------

def distributed_table(pts: list[dict]) -> str:
    """Deep-halo super-stepper leg rows."""
    rows = ["| stencil | grid | devices | t_block | plan | measured GLUP/s "
            f"| {MODEL_LABEL} GLUP/s |",
            "|---|---|---|---|---|---|---|"]
    for p in pts:
        m = p["measured"]
        rows.append(
            f"| {p['stencil']} | {_grid_str(p)} | {m['n_devices']} "
            f"| {m['t_block']} | {_plan_str(p)} | {m['glups']:.5f} "
            f"| {p['model']['glups']:.2f} |")
    return "\n".join(rows)


def _scaling_legs(pts: list[dict]) -> dict[tuple, dict]:
    """(stencil, regime, n_devices) -> {"sync": point, "overlap": point}."""
    legs: dict[tuple, dict] = {}
    for p in pts:
        m = p["measured"]
        ident = (p["stencil"], m["scaling"], m["n_devices"])
        legs.setdefault(ident, {})["overlap" if m.get("overlap")
                                   else "sync"] = p
    return legs


def _paired_ratio(sides: dict) -> float | None:
    """Overlapped/sync speed ratio, drift-free when paired timing exists."""
    if "overlap" not in sides or "sync" not in sides:
        return None
    om = sides["overlap"]["measured"]
    if om.get("paired_sync_t_s"):
        return om["paired_sync_t_s"] / om["t_s"]
    return om["glups"] / sides["sync"]["measured"]["glups"]


def _best_sync_t(sides: dict) -> float | None:
    """Fastest synchronous-leg seconds of one rung: the standalone sync
    point or the overlapped point's paired sync session, whichever is
    lower (noise only adds time)."""
    ts = []
    if "sync" in sides:
        ts.append(sides["sync"]["measured"]["t_s"])
    om = sides.get("overlap", {}).get("measured", {})
    if om.get("paired_sync_t_s"):
        ts.append(om["paired_sync_t_s"])
    return min(ts) if ts else None


def _sync_glups(sides: dict) -> float | None:
    """Synchronous-leg GLUP/s at the `_best_sync_t` measurement."""
    t = _best_sync_t(sides)
    if t is None or "sync" not in sides:
        return None
    sm = sides["sync"]["measured"]
    return sm["glups"] * sm["t_s"] / t


def scaling_table(pts: list[dict]) -> str:
    """Strong/weak ladder: sync vs overlapped throughput per mesh size.

    ``ovl/sync`` is the gate's ratio; ``par eff`` is the synchronous leg's
    GLUP/s(n) / (n * GLUP/s(1)) within the same (stencil, regime) ladder.
    """
    legs = _scaling_legs(pts)
    base = {(st, reg): _sync_glups(sides)
            for (st, reg, n), sides in legs.items() if n == 1}
    rows = ["| stencil | regime | grid | devices | sync GLUP/s "
            "| overlap GLUP/s | ovl/sync | par eff |",
            "|---|---|---|---|---|---|---|---|"]
    for (st, reg, n), sides in sorted(legs.items()):
        syn = _sync_glups(sides)
        if syn is None:
            continue
        ovl = (f"{sides['overlap']['measured']['glups']:.5f}"
               if "overlap" in sides else "-")
        ratio = _paired_ratio(sides)
        ratio_s = f"{ratio:.3f}" if ratio is not None else "-"
        b = base.get((st, reg))
        eff = f"{syn / (n * b):.0%}" if b else "-"
        rows.append(
            f"| {st} | {reg} | {_grid_str(sides['sync'])} | {n} "
            f"| {syn:.5f} | {ovl} | {ratio_s} | {eff} |")
    return "\n".join(rows)


def overlap_model_table(pts: list[dict]) -> str:
    """`models.super_step_time` against the measured overlapped super-step.

    Per (stencil, regime) ladder the per-cell sweep cost is calibrated on
    the one-shard synchronous rung (no exchange there), each rung's
    exchange time is inferred from its synchronous leg (measured super-step
    less its swept cells' cost), and the overlapped super-step is predicted
    as ``max(t_interior, t_exchange) + t_boundary``; the residual is
    (predicted - measured) / measured.
    """
    legs = _scaling_legs(pts)
    t_cell = {}
    for (st, reg, n), sides in legs.items():
        t = _best_sync_t(sides)
        if n == 1 and t is not None and "sync" in sides:
            m = sides["sync"]["measured"]
            t_super = t / m["n_super_steps"]
            t_cell[(st, reg)] = t_super / (m["overlap_work"]["sync_cells"]
                                           * m["t_block"])
    rows = ["| stencil | regime | devices | t_exch ms | interior ms "
            "| boundary ms | predicted ovl ms | measured ovl ms "
            "| residual |",
            "|---|---|---|---|---|---|---|---|---|"]
    for (st, reg, n), sides in sorted(legs.items()):
        tc = t_cell.get((st, reg))
        if tc is None or "overlap" not in sides or "sync" not in sides:
            continue
        om, sm = sides["overlap"]["measured"], sides["sync"]["measured"]
        w = om["overlap_work"]
        t_int = w["interior_cells"] * om["t_block"] * tc
        t_bnd = w["boundary_cells"] * om["t_block"] * tc
        t_sync_super = _best_sync_t(sides) / sm["n_super_steps"]
        t_exch = max(0.0, t_sync_super
                     - w["sync_cells"] * sm["t_block"] * tc)
        pred = models.super_step_time(t_int, t_bnd, t_exch, overlap=True)
        meas = om["t_s"] / om["n_super_steps"]
        rows.append(
            f"| {st} | {reg} | {n} | {t_exch * 1e3:.3f} "
            f"| {t_int * 1e3:.3f} | {t_bnd * 1e3:.3f} | {pred * 1e3:.3f} "
            f"| {meas * 1e3:.3f} | {(pred - meas) / meas:+.0%} |")
    return "\n".join(rows)


def _cards_note(pts: list[dict]) -> list[str]:
    """How many devices the shards of these points shared."""
    cards = sorted({p["measured"].get("cards", 0) for p in pts})
    names = sorted({(p.get("device") or {}).get("name", "?") for p in pts})
    if cards == [1]:
        return [f"Every shard of every point sat on ONE device "
                f"({', '.join(names)}): the halo exchange is",
                "device-to-device copies there, so these rows measure the "
                "cost of the decomposition",
                "(copies, halo redundancy, more launches), not scaling "
                "across devices."]
    return [f"Devices per point: {', '.join(map(str, cards))} "
            f"({', '.join(names)})."]


def _rate(x) -> str:
    return "inf" if x == float("inf") else f"{x:.3e}"


def render(results_dir: str = RESULTS_DIR) -> str:
    """Render the whole REPRODUCTION.md report from `results_dir`."""
    sweeps = load_sweeps(results_dir)
    all_pts = _sorted_points(sweeps["points"])
    pts = [p for p in all_pts if not p.get("distributed")]
    dist = [p for p in all_pts if p.get("distributed")]
    scaling_pts = [p for p in dist if p["measured"].get("scaling")]
    dist_pts = [p for p in dist if not p["measured"].get("scaling")]
    calib = residuals = None
    if len(pts) >= 3:
        fit_pts = [{"key": p["key"], "flops": p["flops"],
                    "hbm_bytes": p["traffic"]["hbm_bytes"],
                    "measured_s": p["measured"]["t_s"],
                    "model_s": p["model"]["t_s"]} for p in pts]
        residuals = models.model_residuals(fit_pts)
        residuals["per_point"].sort(key=lambda e: e["key"])
        calib = models.EcmCalibration(**residuals["calibration"])
    k1_pts = k1_fit_points(pts)
    k1_res = models.k1_residuals(k1_pts) if len(k1_pts) >= 3 else None
    out = []
    out.append("# REPRODUCTION — the paper's performance study on the H100, "
               "regenerated")
    out.append("")
    out.append("> Generated by `python -m repro_torch.launch.report` from "
               "the sweep records under")
    out.append("> `src/repro_torch/results/` (written by `python -m "
               "repro_torch.launch.sweep`). Do NOT edit")
    out.append("> by hand: `--check` re-renders this file from the "
               "committed results and fails on drift.")
    out.append("> Measured columns come from the card named under "
               "Provenance; model columns are the")
    out.append("> a-priori ECM, K1 and energy models of "
               "`repro_torch.core.models` under the recorded device spec.")
    out.append("")
    out.append("## Provenance")
    out.append("")
    out.append(f"- results files: {', '.join(sweeps['files']) or '(none)'}")
    out.append(f"- sweep points: {len(pts)} single-launch"
               + (f", {len(dist_pts)} distributed, {len(scaling_pts)} "
                  f"scaling" if dist else ""))
    out.append("- cards (nvidia-smi name, power limit): "
               + ("; ".join(sweeps["devices"]) or "(none)"))
    out.append("- device specs: "
               + (", ".join(f"`{s}`" for s in sweeps["specs"]) or "(none)"))
    out.append("- hardware fingerprints: "
               + (", ".join(f"`{f}`" for f in sweeps["fingerprints"])
                  or "(none)"))
    out.append("- regenerate: `python -m repro_torch.launch.sweep --sizes "
               "128,256,384,512,640,768 --steps 8 --tune measured` (and the "
               "bf16 leg"
               + (", the `--sizes 512 --steps 8 --distributed --shards 4` "
                  "leg and `--scaling`" if dist else "")
               + ") then `python -m repro_torch.launch.report`")
    out.append("")
    f32 = [p for p in pts if p.get("dtype", "f32") == "f32"]
    by_st = _by_stencil(f32)
    out.append("## 1. Throughput vs grid size (Figs. 8-15 analog)")
    out.append("")
    out.append("Measured GLUP/s of the whole `ops.mwd` call (K1 and its host "
               "side) per grid size, against the")
    out.append("a-priori ECM prediction from the device spec and the "
               "card-calibrated prediction (Sec. 4 below).")
    for name, sp in by_st.items():
        out.append("")
        out.append(f"### {name}")
        out.append("")
        out.append(glups_table(sp, calib))
    out.append("")
    if f32:
        out.append("## 1b. ECM terms & latency-bound detection")
        out.append("")
        out.append("Per-term ECM breakdown under the recorded device spec "
                   "(`t_smem` is the shared-memory term,")
        out.append("all SMs together). A call whose HBM traffic falls under "
                   "the spec's `latency_bytes`")
        out.append("(`hbm_bw * launch_s`) cannot saturate the memory "
                   "system: **dominant** then reads `latency`.")
        for name, sp in by_st.items():
            out.append("")
            out.append(f"### {name}")
            out.append("")
            out.append(ecm_table(sp))
        out.append("")
    out.append("## 2. Memory traffic vs grid size (Fig. 4 analog)")
    out.append("")
    out.append("The idealized Eq. 5 code balance against K1's own schedule "
               "bytes (`repro_torch.core.traffic`:")
    out.append("both parity grids over the windows per diamond row, every "
               "coefficient stream once) and the")
    out.append("optimal spatial-blocking baseline the paper's argument is "
               "measured against.")
    for name, sp in by_st.items():
        out.append("")
        out.append(f"### {name}")
        out.append("")
        out.append(blup_table(sp))
    out.append("")
    if any(p.get("dtype", "f32") != "f32" for p in pts):
        out.append("## 2b. Reduced-precision streams (bf16 vs f32)")
        out.append("")
        out.append("Sub-32-bit streams with float32 accumulation: the word "
                   "size halves every stream K1 moves,")
        out.append("so its B/LUP drops to 0.5x at an identical plan "
                   "(`python -m repro_torch.launch.precision_gate`")
        out.append("holds it at most 0.6x).")
        out.append("")
        out.append(dtype_table(pts))
        out.append("")
    out.append("## 3. Energy vs tuning choice (Fig. 19 analog)")
    out.append("")
    out.append("Modeled energy split `E = e_flop*F + e_byte*B_hbm + "
               "P_static*T` at the ECM runtime, with the")
    out.append("spec's constants measured on the card (`chip_smoke.py` "
               "energy phase).")
    for name, sp in by_st.items():
        out.append("")
        out.append(f"### {name}")
        out.append("")
        out.append(energy_table(sp))
    out.append("")
    out.append("## 4. Model validation (Sec. 7 analog)")
    out.append("")
    if residuals is None:
        out.append("(needs at least 3 measured sweep points — run "
                   "`python -m repro_torch.launch.sweep`)")
    else:
        c = residuals["calibration"]
        out.append("Effective ECM constants fitted from the measured points "
                   "(`models.fit_ecm`,")
        out.append("`t = F/flops_per_s + B_hbm/hbm_bytes_per_s + "
                   "t_dispatch_s`):")
        out.append("")
        out.append("| constant | fitted value |")
        out.append("|---|---|")
        out.append(f"| `flops_per_s` | {_rate(c['flops_per_s'])} |")
        out.append(f"| `hbm_bytes_per_s` | {_rate(c['hbm_bytes_per_s'])} |")
        out.append(f"| `t_dispatch_s` | {c['t_dispatch_s']:.2e} |")
        out.append(f"| points | {c['n_points']} |")
        if c.get("spec"):
            out.append(f"| device spec | `{c['spec']}` |")
        out.append("")
        out.append(f"Residuals (calibrated vs measured): mean abs "
                   f"{residuals['mean_abs_rel_err']:.0%}, max abs "
                   f"{residuals['max_abs_rel_err']:.0%}, bias "
                   f"{residuals['bias']:+.0%}.")
        out.append("")
        out.append(residual_table(residuals))
    out.append("")
    out.append("### 4b. K1's phase model (`models.fit_k1`)")
    out.append("")
    if k1_res is None:
        out.append("(needs at least 3 points that timed K1 alone on the "
                   "card)")
    else:
        c = k1_res["calibration"]
        out.append("K1 alone (CUDA events) against `models.k1_predict`: "
                   "the spec's committed phase costs")
        out.append("(`spec model s`) and the costs refitted over these "
                   "points (`t = fixed + cost * phases x waves`):")
        out.append("")
        out.append("| constant | fitted value |")
        out.append("|---|---|")
        for name, v in c["costs_s"].items():
            out.append(f"| `{name}` | {v:.3e} |")
        out.append(f"| points | {c['n_points']} |")
        out.append("")
        out.append(f"Residuals (refitted vs measured): mean abs "
                   f"{k1_res['mean_abs_rel_err']:.0%}, max abs "
                   f"{k1_res['max_abs_rel_err']:.0%}, bias "
                   f"{k1_res['bias']:+.0%}.")
        out.append("")
        out.append(k1_residual_table(k1_res))
    out.append("")
    if dist_pts:
        out.append("## 5. Distributed super-stepper leg")
        out.append("")
        out.append("Deep-halo super-steps (`repro_torch.distributed.stepper`)"
                   ", synchronous, one K1 advance per")
        out.append("shard per halo exchange, the plan resolved against each "
                   "shard's extended block.")
        out += _cards_note(dist_pts)
        out.append("")
        out.append(distributed_table(dist_pts))
        out.append("")
    if scaling_pts:
        out.append("## 5b. Strong/weak scaling: overlapped vs synchronous "
                   "super-steps")
        out.append("")
        out.append("`python -m repro_torch.launch.sweep --scaling` walks the "
                   "shard ladder 1 -> 2 -> 4 -> 8")
        out.append("twice per stencil: STRONG (fixed global grid, shards "
                   "shrink) and WEAK (fixed per-shard")
        out.append("block, grid grows with the shard count), each rung timed "
                   "synchronously and overlapped (the")
        out.append("interior advance beside the halo copies) on the plain "
                   "route; `ovl/sync` is the interleaved")
        out.append("paired ratio `python -m repro_torch.launch.scaling_gate` "
                   "holds on the largest mesh.")
        out += _cards_note(scaling_pts)
        out.append("")
        out.append(scaling_table(scaling_pts))
        out.append("")
        out.append("### Overlap-model residuals (Sec. 4.2 analog)")
        out.append("")
        out.append("`repro_torch.core.models.super_step_time` predicts the "
                   "overlapped super-step as")
        out.append("`max(t_interior, t_exchange) + t_boundary`, the per-cell "
                   "cost calibrated on each ladder's")
        out.append("one-shard synchronous rung and `t_exchange` inferred per "
                   "rung from its synchronous leg.")
        out.append("")
        out.append(overlap_model_table(scaling_pts))
        out.append("")
    return "\n".join(out).rstrip() + "\n"


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    """CLI entry point; returns a process exit code (tested directly)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.report",
        description="Render the port's sweeps into its REPRODUCTION.md")
    ap.add_argument("--results", default=RESULTS_DIR,
                    help="results directory holding sweep*.json")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="report path to write (or compare with --check)")
    ap.add_argument("--check", action="store_true",
                    help="do not write: re-render and fail (exit 2) if the "
                         "committed report differs")
    args = ap.parse_args(argv)
    text = render(args.results)
    if args.check:
        try:
            with open(args.out) as f:
                committed = f.read()
        except OSError:
            print(f"--check: {args.out} missing; run `python -m "
                  f"repro_torch.launch.report` and commit it")
            return 2
        if committed != text:
            got, want = committed.splitlines(), text.splitlines()
            for i, (a, b) in enumerate(zip(got, want)):
                if a != b:
                    print(f"--check: {args.out} drifts from regeneration at "
                          f"line {i + 1}:\n  committed: {a}\n  rendered:  {b}")
                    break
            else:
                print(f"--check: {args.out} drifts from regeneration "
                      f"(length {len(got)} vs {len(want)} lines)")
            print("re-run `python -m repro_torch.launch.report` and commit "
                  "the regenerated report")
            return 2
        print(f"--check: {args.out} matches regeneration "
              f"({len(text.splitlines())} lines)")
        return 0
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)
    print(f"wrote {args.out} ({len(text.splitlines())} lines)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
