"""The LAMP cell on the genotype table `alz_dom_5`: its configuration and mix
load, the float32 control fails its P-value check, a test-size copy of the
cell runs on the CPU with every metric it lists, and the readers of the
candidate pass's work read the `dispatch` spans' args."""

from __future__ import annotations

import copy
import dataclasses
import math
import time

import pytest

from chipbench.harness import judge
from chipbench.harness.cell import run_cell
from chipbench.harness.spec import load_cell, load_metric
from chipbench.harness.tracectx import Trace
from chipbench.readings import control_readings

CELL = "lamp_alz_dom_5.queries"
PASS_READERS = ("expand_fill_pct", "scan_cells_per_node")


def test_the_cell_loads_its_config_mix_and_metrics():
    cell = load_cell(CELL)
    d = cell.config["dataset"]
    assert (d["n_items"], d["n_transactions"], d["n_pos"], d["skew"]) == (44052, 364, 176, 4.0)
    assert cell.config["reduced"] == []
    assert cell.config["bucket"] == [512, 256, 65536]
    assert cell.traffic["params"] == [{"alpha": 0.05}, {"alpha": 0.01}, {"alpha": 0.001}]
    assert {m["name"] for m in cell.end_to_end} == {"query_s", "query_p95_s", "setup_s"}
    mcf7 = {m["name"] for m in load_cell("lamp_mcf7.queries").per_layer}
    assert {m["name"] for m in cell.per_layer} == (
        mcf7 | set(PASS_READERS) | {"support_count_roofline"})
    for other in ("lamp_mcf7.queries", "closed_alz_rec_30.queries"):
        assert set(PASS_READERS) <= {m["name"] for m in load_cell(other).per_layer}


def small_cell():
    """The cell at 1,500 items x 96 transactions (3 words), skew 4.0."""
    cell = load_cell(CELL)
    config = copy.deepcopy(cell.config)
    config["dataset"].update(n_items=1500, n_transactions=96, n_pos=46)
    config["layout"].update(miners=4, expand_batch=16)
    del config["bucket"]
    return dataclasses.replace(cell, config=config)


def test_the_float32_control_fails_the_pvalue_check():
    numbers = control_readings(small_cell(), seed=2**31 + 41)
    assert not judge.passed(numbers)
    assert numbers["pvalue_rel_gap"]["value"] > numbers["pvalue_rel_gap"]["limit"]


def test_a_test_size_run_is_correct_with_every_metric_it_lists():
    res, checks = run_cell(small_cell(), seed=2**31 + 43, seconds=1.0, trace=True,
                           device="cpu", t_start=time.perf_counter())
    assert res["correct"], checks
    assert checks["pvalue_rel_gap"]["value"] <= 1e-8
    device_only = {"device_kernels_per_superstep", "device_idle_pct.queries",
                   "support_count_roofline"}
    for m in small_cell().per_layer:
        if m["name"] not in device_only:
            assert math.isfinite(res["metrics"][m["name"]]["value"]), m["name"]
    assert 0 < res["metrics"]["expand_fill_pct"]["value"] <= 100
    assert res["metrics"]["scan_cells_per_node"]["value"] >= 1500


def dispatch(**args):
    return {"name": "dispatch", "ph": "X", "ts": 0.0, "dur": 5.0, "tid": 1, "args": args}


def test_the_pass_readers_on_a_planted_trace():
    """Two requests, three passes: 300 nodes popped over 10 supersteps of
    32 rows (fill 300 / 320), each superstep scanning 32 x 1,000 cells."""
    spans = [[dispatch(cache_hit=True, popped=100, supersteps=4, rows=32, items=1000),
              dispatch(cache_hit=True, popped=150, supersteps=5, rows=32, items=1000)],
             [dispatch(cache_hit=True, popped=50, supersteps=1, rows=32, items=1000)]]
    tr = Trace(driver="session",
               requests=[dict(wall_s=0.1, supersteps=9, spans=spans[0]),
                         dict(wall_s=0.1, supersteps=1, spans=spans[1])])
    assert load_metric("expand_fill_pct")(tr) == pytest.approx(100.0 * 300 / 320)
    assert load_metric("scan_cells_per_node")(tr) == pytest.approx(10 * 32 * 1000 / 300)


def test_the_pass_readers_read_nothing_without_the_args():
    old = Trace(driver="session", requests=[dict(
        wall_s=0.1, supersteps=3, spans=[dispatch(cache_hit=True)])])
    idle = Trace(driver="session", requests=[dict(
        wall_s=0.1, supersteps=0, spans=[dispatch(popped=0, supersteps=0, rows=8, items=64)])])
    for name in PASS_READERS:
        assert load_metric(name)(old) is None, name
        assert load_metric(name)(idle) is None, name
        assert load_metric(name)(Trace(driver="served")) is None, name
