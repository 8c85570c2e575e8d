"""Define your own stencil: a user operator through the whole port.

The IR (`repro_torch.core.ir`) is the one source of truth: list the taps
once and the port derives the torch sweep, the analytics (FLOPs/LUP,
streams, code balance), K1's coefficient layout, the tuned MWD plan and
the registry key, with no kernel edits.

  python -m repro_torch.examples.custom_stencil               # on the card
  python -m repro_torch.examples.custom_stencil --device cpu

Registered, the op is tunable and servable by name:

  python -m repro_torch.launch.tune \\
      --stencil repro_torch.examples.custom_stencil:OP --grid 256,256,256
  python -m repro_torch.launch.serve \\
      --stencil repro_torch.examples.custom_stencil:OP --requests 4

The port of ``examples/custom_stencil.py``: on the CPU at its grid (12 x
18 x 16), on the card at 256^3.
"""

from __future__ import annotations

import argparse

from repro_torch.core import ir
from repro_torch.core import stencils as st
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

# An 11-point anisotropic operator: variable-coefficient star along z/y
# (symmetric pairs share one stream) + a high-order compile-time-constant
# stencil along x. Not one of the paper's four: that is the point.
_taps = [ir.Tap(0, 0, 0, ir.array(0))]
for ax, slot in ((0, 1), (1, 2)):                  # z/y pairs, one array each
    off = [0, 0, 0]
    off[ax] = 1
    _taps += [ir.Tap(*off, ir.array(slot)),
              ir.Tap(*[-v for v in off], ir.array(slot))]
for d in (1, 2, 3):                                # R=3 const star along x
    _taps += [ir.Tap(0, 0, d, ir.const(d - 1)),
              ir.Tap(0, 0, -d, ir.const(d - 1))]

OP = ir.register(ir.StencilOp(
    "aniso11", tuple(_taps),
    default_scalars=(0.08, 0.04, 0.02), coeff_scale=0.08))

CPU_GRID = (12, 18, 16)
CARD_GRID = (256, 256, 256)
STEPS = 4
TOLERANCE = 1e-4                # the reference's bound against naive


def run_methods(state, coeffs, n_steps: int = STEPS) -> dict:
    """``(cur, prev)`` of naive, ``plan="auto"`` and the fused launch."""
    return {
        "naive": st.run_naive(OP, state, coeffs, n_steps),
        "mwd-auto": ops.mwd(OP, state, coeffs, n_steps, plan="auto"),
        "mwd-fused": ops.mwd(OP, state, coeffs, n_steps, d_w=2 * OP.radius,
                             n_f=2),
    }


def main(argv=None) -> dict:
    """Returns ``{method: max|err| vs naive}``."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "custom_stencil")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"op {OP.name}: {len(OP.taps)} taps, radius {OP.radius} "
          f"(per-axis {OP.radii}), {OP.flops_per_lup} FLOPs/LUP, "
          f"N_D={OP.n_streams}, spatial balance "
          f"{OP.spatial_code_balance(8):.0f} B/LUP, "
          f"fingerprint {OP.fingerprint}")
    grid = CARD_GRID if dev.type == "cuda" else CPU_GRID
    draw = st.random_problem if dev.type == "cuda" else st.make_problem
    state, coeffs = draw(OP, grid, seed=0, device=dev)
    outs = run_methods(state, coeffs)
    ref = outs.pop("naive")
    errs = {}
    for name, out in outs.items():
        errs[name] = float((out[0].double() - ref[0].double()).abs().max())
        print(f"{name:10s} max|err| vs naive = {errs[name]:.2e}")
        if errs[name] >= TOLERANCE:
            raise RuntimeError(f"{name} disagrees with naive: {errs[name]}")
    print(f"custom operator matches the naive oracle end to end on {dev}")
    return errs


if __name__ == "__main__":
    main()
