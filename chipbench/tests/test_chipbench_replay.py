"""The reader of the superstep replay share: the `superstep` spans' arg
`graph`, on a tiny traced CPU run (the CPU runs every superstep eagerly)
and on spans as a card records them."""

from __future__ import annotations

import time

from chipbench.harness import cell as cell_mod
from chipbench.harness.spec import load_metric
from chipbench.harness.tracectx import Trace

READER = "superstep_replay_pct"


def test_a_cpu_run_replays_no_superstep(cell_factory):
    res, _ = cell_mod.run_cell(cell_factory("closed", "session"), seed=2**31 + 11,
                               seconds=1.5, trace=True, device="cpu",
                               t_start=time.perf_counter())
    assert res["correct"], res
    assert res["metrics"][READER]["value"] == 0.0


def test_the_share_counts_the_replayed_supersteps():
    def step(graph=None):
        args = {"t": 0} if graph is None else {"t": 0, "graph": graph}
        return {"name": "superstep", "ph": "X", "ts": 0.0, "dur": 1.0, "tid": 1,
                "args": args}

    read = load_metric(READER)
    spans = [step(False), step(True), step(True), step(True),
             {"name": "census.read", "ph": "X", "ts": 0.0, "dur": 1.0, "tid": 1}]
    tr = Trace(driver="session", requests=[dict(wall_s=0.1, supersteps=4, spans=spans)])
    assert read(tr) == 75.0
    # a program whose superstep spans carry no `graph` arg: nothing to read
    old = Trace(driver="session", requests=[dict(wall_s=0.1, supersteps=2,
                                                 spans=[step(), step()])])
    assert read(old) is None
    assert read(Trace(driver="served")) is None
