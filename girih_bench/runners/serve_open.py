"""Open-loop serving: seeded Poisson arrivals into `serve.serve_queue`.

Traffic parameters: ``tenants`` resident grids whose axes take the values
of ``axes`` (each axis's list is ``axes`` repeated to ``tenants`` values),
``ladder`` (the padding ladder), ``steps`` a request, ``max_batch``,
``batch_window_ms``, ``rate_per_s`` (the fixed offered rate),
``segment_s`` and ``segment_requests`` (see below), ``sample`` (answers
judged against the reference), ``warm_s`` and ``layout_seed``.

Every seed serves the same set of tenant grids and the same arrival
times, in another order: the grids' shapes and the due times are drawn
from ``layout_seed``, a number of the traffic file, and the run's seed
draws the tenants' data, which shape each tenant has, which tenant each
request is for (in turn from permutations of all tenants) and the sample.
A tail read over seconds of arrivals swings with the arrivals' own
clusters far more than between two runs of one schedule; fixing the times
keeps that swing out of the cell's spread.

Set-up draws the tenants, launches every batch signature once
(`serve.warm`) and then serves ``warm_s`` of the same traffic (a schedule
of its own), so that the allocator's pool has grown to hold a segment's
responses before the window opens.

The window's arrival schedule is made up front: ``round(rate * seconds)``
due times spread uniformly over the window, a Poisson process given its
count.

`serve_queue` keeps every response until it returns, so the schedule is
fed to it in consecutive segments of ``segment_s`` of due times, shorter
where a segment would hold more than ``segment_requests`` responses. A
segment's arrival offsets are taken from the moment it is handed over, so
requests that came due while the previous segment drained are admitted at
once. Every request is timed from its due time to its batch's end on the
window's clock: a telemetry sink (`Clock`) notes the host clock as each
launch is reported, which places `serve_queue`'s own clock, started after
it has sorted and keyed the segment, on the window's. So a drain at a
segment's end, and the host work between segments, show in the latencies. Between
segments the responses are dropped, save the sampled ones. A rejected
request counts as later than every served one: its latency is taken as the
window's whole length plus the minute a late answer is waited for.
"""

from __future__ import annotations

import time

import numpy as np
from torch.profiler import record_function

from girih_bench import check, inputs
from girih_bench.reference import stencils as ref

LATE_S = 60.0


def tenant_shapes(traffic: dict, seed: int) -> list[tuple[int, int, int]]:
    """Each tenant's grid: per axis, ``axes`` repeated to one value a
    tenant, combined in the layout's order, then dealt to the tenants in
    the run's order."""
    n, axes = traffic["tenants"], traffic["axes"]
    values = [axes[i % len(axes)] for i in range(n)]
    layout = np.random.default_rng([traffic["layout_seed"], 2])
    cols = [layout.permutation(values) for _ in range(3)]
    order = np.random.default_rng([seed, 2]).permutation(n)
    return [tuple(int(c[i]) for c in cols) for i in order]


def schedule(traffic: dict, seconds: float, seed: int, stream: int,
             rate: float | None = None):
    """``(due_s, tenant)`` arrays of the window's requests, by due time:
    the layout's due times, the run's tenants."""
    rate = traffic["rate_per_s"] if rate is None else rate
    n = max(1, round(rate * seconds))
    layout = np.random.default_rng([traffic["layout_seed"], stream])
    due = np.sort(layout.uniform(0.0, seconds, n))
    rng = np.random.default_rng([seed, stream])
    rounds = -(-n // traffic["tenants"])
    tenant = np.concatenate([rng.permutation(traffic["tenants"])
                             for _ in range(rounds)])[:n]
    return due, tenant


def segments(due, traffic: dict, rate: float) -> list[np.ndarray]:
    """Consecutive index ranges of `due`, each at most ``segment_s`` of due
    times and at most ``segment_requests`` requests long."""
    length = min(traffic["segment_s"], traffic["segment_requests"] / rate)
    edges = np.searchsorted(due, np.arange(0.0, due[-1] + length, length),
                            side="left")
    bounds = list(edges[1:]) + [len(due)]
    out, lo = [], 0
    for hi in bounds:
        if hi > lo:
            out.append(np.arange(lo, hi))
            lo = hi
    return out


def problems(cell) -> list[inputs.Problem]:
    """The tenants' resident grids, drawn in turn from one generator."""
    cfg = cell.config
    shapes = tenant_shapes(cell.traffic, cell.seed)
    gen = inputs.generator(cell.seed, cell.device)
    out = []
    for shape in shapes:
        arrays, scalars = inputs.coefficients(cfg, shape, gen, cell.device)
        out.append(inputs.Problem(inputs.levels(cfg, shape, gen,
                                                cell.device),
                                  arrays, scalars))
    return out


def clock():
    """A `serve_queue` telemetry sink whose ``starts`` hold, for each
    launch, the host clock when it was reported less its ``done_s``: the
    least of them is when the server's clock started, to microseconds."""
    from repro_torch.launch import telemetry

    class Clock(telemetry.Telemetry):
        """Keeps the start of the server's clock as each launch saw it."""

        def __init__(self):
            self.starts = []

        def emit(self, event: str, **fields) -> None:
            """Note a launch's report; drop every other event."""
            if event == "launch":
                self.starts.append(time.perf_counter() - fields["done_s"])

    return Clock()


class Runner:
    """Set-up, window and check of the open-loop serving."""

    def __init__(self, cell):
        from repro_torch.core import ir, padding
        from repro_torch.launch import serve
        self.cell, self.serve = cell, serve
        tr = cell.traffic
        self.spec = ir.resolve_op(cell.config["operator"])
        self.ladder = padding.parse_ladder(tr["ladder"])
        self.tenants = problems(cell)
        # one answer a tenant is kept: copied into buffers made here, so
        # the window allocates nothing of its own
        self.kept = [tuple(x.clone() for x in p.state) for p in self.tenants]
        classes = serve.padding_classes(
            [(p.state, p.coeffs) for p in self.tenants], self.ladder)
        serve.warm(self.spec, classes, tr["max_batch"], tr["steps"], "auto")
        self.window(tr["warm_s"], stream=4)
        cell.sync()

    def window(self, seconds: float, rate: float | None = None,
               stream: int = 3) -> dict:
        """Serve `seconds` of arrivals at `rate` (default the cell's),
        the schedule of `stream`; the window's record."""
        tr, serve = self.cell.traffic, self.serve
        rate = tr["rate_per_s"] if rate is None else rate
        due, tenant = schedule(tr, seconds, self.cell.seed, stream, rate)
        rng = np.random.default_rng([self.cell.seed, stream, 1])
        n = len(due)
        pick = {}
        for t in range(tr["tenants"]):
            mine = np.flatnonzero(tenant == t)
            if len(mine) and len(pick) < tr["sample"]:
                pick[int(rng.choice(mine))] = t
        latency = np.full(n, np.nan)
        waits, launches, rejected, answers = [], [], 0, []
        t0 = time.perf_counter()
        for idx in segments(due, tr, rate):
            reqs = [serve.StencilRequest(
                rid=int(i), spec=self.spec,
                state=self.tenants[tenant[i]].state,
                coeffs=self.tenants[tenant[i]].coeffs, n_steps=tr["steps"])
                for i in idx]
            sink = clock()
            t_call = time.perf_counter() - t0
            for r in reqs:
                r.arrival_s = max(0.0, float(due[r.rid]) - t_call)
            with record_function("girih.serve_queue"):
                results, records = serve.serve_queue(
                    reqs, max_batch=tr["max_batch"],
                    batch_window_ms=tr["batch_window_ms"], plan="auto",
                    ladder=self.ladder, telemetry=sink)
            start = min(sink.starts, default=t0) - t0
            for rec in records:
                done = start + rec["done_s"]
                for rid in rec["rids"]:
                    latency[rid] = done - due[rid]
                    waits.append(done - rec["launch_s"] - due[rid])
                launches.append({"size": rec["size"],
                                 "launch_s": rec["launch_s"],
                                 "waste": rec["waste"]})
            for i in idx:
                out = results.get(int(i))
                if isinstance(out, serve.Rejected) or out is None:
                    rejected += 1
                elif int(i) in pick:
                    t = pick[int(i)]
                    for dst, src in zip(self.kept[t], out):
                        dst.copy_(src)
                    answers.append((t, self.kept[t]))
            del results, records
        wall = time.perf_counter() - t0
        latency[np.isnan(latency)] = wall + LATE_S
        self.answers = answers
        p50, p95 = np.percentile(latency, [50, 95])
        return {"end_to_end": {"serve_p50_ms": 1e3 * float(p50),
                               "serve_p95_ms": 1e3 * float(p95)},
                "attempted": n, "failed": rejected, "window_s": wall,
                "latency_s": latency, "due_s": due, "waits": waits,
                "launches": launches, "rate_per_s": rate}

    def check(self) -> dict:
        """The largest gap of the sampled responses against the
        reference."""
        cfg, steps = self.cell.config, self.cell.traffic["steps"]
        gap = 0.0 if self.answers else check.NOT_FINITE
        for t in sorted({t for t, _ in self.answers}):
            p = self.tenants[t]
            want = ref.advance(ref.name_of(cfg), p.state, p.arrays,
                               p.scalars, steps)
            gap = max([gap] + [check.state_gap(a, want)
                               for j, a in self.answers if j == t])
        self.answers = []
        return {"gap": gap}
