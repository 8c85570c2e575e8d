"""The port's core: IR, schedules, the MWD oracles and serving policy.

* `precision` — dtype short names and accumulator policy (torch dtypes)
* `ir`        — declarative StencilOp IR and the generated torch sweep
* `stencils`  — the four paper operators + step / naive API
* `listings`  — the paper's Listings 1-4 by hand, which pin `ir.make_sweep`
* `tiling`    — diamond tessellation and the schedule compiler (numpy)
* `mwd`       — `MWDPlan` and the span-update oracles of the MWD kernel
* `scheduler` — serving queue policy (lanes, admission, windows)
* `padding`   — exact padding ladder of the serving tier
* `specs`     — declarative device specs (the H100's in ``specs/``)
* `models`    — the paper's equations, K1's fit twin and time model
* `traffic`   — HBM bytes of the port's kernels, from their schedules
* `autotune`  — the paper's model-pruned search, measured or modeled
* `registry`  — the port's persistent plan registry and plan translation
"""
