"""The port's dynamic tile scheduler (paper Sec. 4.2.3) vs the reference.

The reference's five tests of `repro.core.scheduler` run on the port's
`core.scheduler`, over graphs built from the port's `core.tiling`; one more
holds the port's diamond tile graph equal to the reference's.
"""

import threading
import time

import pytest

from repro.core import scheduler as rsched
from repro.core import tiling as rtiling
from repro_torch.core import scheduler
from repro_torch.core import tiling

SCHEDULE = (8, 1, 16, 1, 63)    # d_w, radius, t_total, y_lo, y_hi


def _graph():
    return scheduler.from_diamond_schedule(
        tiling.make_diamond_schedule(*SCHEDULE))


def test_all_tiles_executed_once_in_dependency_order():
    g = _graph()
    fifo = scheduler.FifoScheduler(g)
    done, lock = [], threading.Lock()

    def ex(k):
        with lock:
            done.append(k)

    fifo.run(ex, n_workers=4)
    assert sorted(done) == sorted(g.deps)
    pos = {k: i for i, k in enumerate(done)}
    for k, ds in g.deps.items():
        for d in ds:
            assert pos[d] < pos[k], (d, k)


def test_straggler_does_not_stall_queue():
    g = _graph()
    fifo = scheduler.FifoScheduler(g)
    counts = {}
    lock = threading.Lock()

    def ex(k):
        if k[1] == 0:        # one column is 50x slower (straggler group)
            time.sleep(0.005)
        with lock:
            name = threading.current_thread().name
            counts[name] = counts.get(name, 0) + 1

    logs = fifo.run(ex, n_workers=4)
    assert sum(len(log) for log in logs) == len(g.deps)
    # the fast workers pick up the slack: no worker does everything
    assert max(len(log) for log in logs) < len(g.deps)


def test_cycle_detection():
    g = scheduler.TileGraph({"a": ["b"], "b": ["a"]})
    with pytest.raises(ValueError):
        scheduler.topological_order(g)


def test_unknown_dependency_rejected():
    g = scheduler.TileGraph({"a": ["zz"]})
    with pytest.raises(ValueError):
        scheduler.FifoScheduler(g)


def test_worker_exception_propagates():
    g = scheduler.TileGraph({"a": [], "b": ["a"]})
    fifo = scheduler.FifoScheduler(g)

    def ex(k):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError):
        fifo.run(ex, n_workers=2)


@pytest.mark.parametrize("args", [SCHEDULE, (4, 1, 12, 2, 30),
                                  (8, 4, 24, 1, 50)])
def test_diamond_graph_and_order_equal_reference(args):
    want = rsched.from_diamond_schedule(rtiling.make_diamond_schedule(*args))
    got = scheduler.from_diamond_schedule(tiling.make_diamond_schedule(*args))
    assert dict(got.deps) == dict(want.deps)
    assert (scheduler.topological_order(got)
            == rsched.topological_order(want))
