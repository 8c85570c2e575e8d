"""Back-to-back solves: ``ops.mwd(spec, state, coeffs, steps, plan="auto")``.

Traffic parameters: ``steps`` a call and ``states``, the number of seeded
initial states the calls take in turn (they share one set of coefficient
arrays). Calls are dispatched back to back, at most two ahead of the
device; the window ends in a synchronize once its seconds have passed on
the host clock. One answer of each state is kept at random (a reservoir
drawn from the seed) beside that state's last answer, and both are judged
against the plain reference's run from that state.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch
from torch.profiler import record_function

from girih_bench import check, inputs, roofline
from girih_bench.reference import stencils as ref


def problems(cell) -> list[inputs.Problem]:
    """The seeded initial states, sharing one set of coefficients."""
    cfg, grid = cell.config, tuple(cell.config["grid"])
    gen = inputs.generator(cell.seed, cell.device)
    arrays, scalars = inputs.coefficients(cfg, grid, gen, cell.device)
    return [inputs.Problem(inputs.levels(cfg, grid, gen, cell.device),
                           arrays, scalars)
            for _ in range(cell.traffic["states"])]


class Runner:
    """Set-up, window and check of the back-to-back solves."""

    def __init__(self, cell):
        from repro_torch.core import ir
        from repro_torch.kernels import ops, stencil_mwd
        self.cell, self.ops, self.launches = cell, ops, stencil_mwd.LAUNCHES
        self.spec = ir.resolve_op(cell.config["operator"])
        self.steps = cell.traffic["steps"]
        self.problems = problems(cell)
        self.bound = roofline.call_bound(cell.config, cell.config["grid"],
                                         self.steps)
        self.rng = np.random.default_rng([cell.seed, 1])
        for p in self.problems:            # plan resolution, kernel load
            self._call(p)
        cell.sync()

    def _call(self, p):
        with record_function("girih.call"):
            return self.ops.mwd(self.spec, p.state, p.coeffs, self.steps,
                                plan="auto")

    def window(self, seconds: float) -> dict:
        """Calls back to back for `seconds`; the window's record."""
        n = len(self.problems)
        kept = [None] * n                 # reservoir sample of each state
        last = [None] * n
        seen = [0] * n
        in_flight = collections.deque()
        launches0, calls = self.launches.count, 0
        t0 = time.perf_counter()
        while True:
            k = calls % n
            out = self._call(self.problems[k])
            seen[k] += 1
            if self.rng.integers(seen[k]) == 0:
                kept[k] = out
            last[k] = out
            calls += 1
            if self.cell.device.type == "cuda":
                in_flight.append(torch.cuda.Event())
                in_flight[-1].record()
                if len(in_flight) > 2:
                    in_flight.popleft().synchronize()
            if time.perf_counter() - t0 >= seconds:
                break
        self.cell.sync()
        wall = time.perf_counter() - t0
        self.answers = [(k, a) for k in range(n)
                        for a in {id(x): x for x in (kept[k], last[k])
                                  if x is not None}.values()]
        lups = calls * self.bound["lups"]
        return {"end_to_end": {"solve_glups": lups / wall / 1e9},
                "attempted": calls, "failed": 0, "calls": calls,
                "window_s": wall, "bound_s": self.bound["seconds"],
                "k1_launches": self.launches.count - launches0}

    def check(self) -> dict:
        """The largest gap of the kept answers against the reference."""
        gap = 0.0
        cfg = self.cell.config
        for k, p in enumerate(self.problems):
            mine = [a for j, a in self.answers if j == k]
            if not mine:
                continue
            want = ref.advance(ref.name_of(cfg), p.state, p.arrays,
                               p.scalars, self.steps)
            gap = max([gap] + [check.state_gap(a, want) for a in mine])
            del want
        self.answers = []
        return {"gap": gap}
