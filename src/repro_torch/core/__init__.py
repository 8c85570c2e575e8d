"""The port's core: IR, schedules, the MWD oracles and serving policy.

* `precision` — dtype short names and accumulator policy (torch dtypes)
* `ir`        — declarative StencilOp IR and the generated torch sweep
* `stencils`  — the four paper operators + step / naive API
* `tiling`    — diamond tessellation and the schedule compiler (numpy)
* `mwd`       — `MWDPlan` and the span-update oracles of the MWD kernel
* `scheduler` — serving queue policy (lanes, admission, windows)
* `padding`   — exact padding ladder of the serving tier
"""
