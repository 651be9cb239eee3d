"""The readers of the spans beneath the query, on a tiny traced CPU run of
each driver: each gives a finite, non-negative value where its span is
recorded and None where it is not, and the spans inside `dispatch` fit in
it."""

from __future__ import annotations

import math
import time

import pytest

from chipbench.harness import cell as cell_mod
from chipbench.harness.spec import load_metric
from chipbench.harness.tracectx import Trace

SESSION_READERS = ("roots_ms", "carry_ms", "loop_step_ms", "census_read_ms", "outputs_ms",
                   "closure_readback_ms", "closure_scan_ms")
SERVED_READERS = ("serve_self_ms.served",)


def traced_run(cell, monkeypatch):
    """(result line, the Trace the harness read it from) of a short traced
    run of `cell` on the CPU."""
    seen = []
    read = cell_mod._read_trace

    def keep(cell, tr, inputs, span_names):
        seen.append(tr)
        return read(cell, tr, inputs, span_names)

    monkeypatch.setattr(cell_mod, "_read_trace", keep)
    res, _ = cell_mod.run_cell(cell, seed=2**31 + 7, seconds=1.5, trace=True, device="cpu",
                               t_start=time.perf_counter())
    assert res["correct"], res
    return res, seen[0]


@pytest.mark.parametrize("driver", ["session", "served"])
def test_each_reader_reads_its_spans(cell_factory, monkeypatch, driver):
    res, tr = traced_run(cell_factory("closed", driver), monkeypatch)
    ours, others = ((SESSION_READERS, SERVED_READERS) if driver == "session"
                    else (SERVED_READERS, SESSION_READERS))
    for name in ours:
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0.0, name
    for name in others:
        assert name not in res["metrics"], name
        assert load_metric(name)(tr) is None, name


def test_the_spans_inside_dispatch_fit_in_it(cell_factory, monkeypatch):
    _, tr = traced_run(cell_factory("closed", "session"), monkeypatch)
    spans = [e for r in tr.requests for e in r["spans"]]

    def total(name):
        return sum(e["dur"] for e in spans if e["name"] == name)

    assert total("dispatch") > 0
    assert total("carry") + total("superstep") + total("outputs") <= total("dispatch")
    steps = sum(r["supersteps"] for r in tr.requests)
    assert sum(e["name"] == "superstep" for e in spans) == steps


def test_readers_of_a_program_without_the_spans_read_nothing():
    """A program that records none of these spans (an older one): every
    reader returns None, and the line leaves the metric out."""
    old = [{"name": n, "ph": "X", "ts": 0.0, "dur": 5.0, "tid": 1}
           for n in ("query:ClosedFrequentQuery", "phase:test", "pack", "dispatch",
                     "postprocess", "reconstruct")]
    session = Trace(driver="session", requests=[dict(wall_s=0.1, supersteps=2, spans=old)])
    served = Trace(driver="served", host_spans=[(e["name"], 0.0, 5.0, 1) for e in old])
    for name in SESSION_READERS + SERVED_READERS:
        assert load_metric(name)(session) is None, name
        assert load_metric(name)(served) is None, name


def test_serve_self_time_leaves_out_the_spans_inside_each_request():
    spans = [("serve.request", 0.0, 100.0, 7), ("query:Q", 10.0, 80.0, 7),
             ("phase:test", 20.0, 70.0, 7), ("serve.request", 200.0, 250.0, 7),
             ("query:Q", 205.0, 245.0, 7), ("serve.request", 0.0, 40.0, 9),
             ("query:Q", 30.0, 60.0, 8)]
    tr = Trace(driver="served", host_spans=spans)
    # (100 - 70) and (50 - 40) on thread 7; 40 - 0 on thread 9, whose query
    # ran on another thread
    assert load_metric("serve_self_ms.served")(tr) == pytest.approx((30 + 10 + 40) / 3 / 1e3)
