"""The LAMP cell on `mcf7`: its configuration and mix load, the float32
control fails its P-value check, and a test-size copy of the cell runs on
the CPU with the pipeline's metrics."""

from __future__ import annotations

import copy
import dataclasses
import time

from chipbench.harness import judge
from chipbench.harness.cell import run_cell
from chipbench.harness.spec import load_cell
from chipbench.readings import control_readings

CELL = "lamp_mcf7.queries"


def test_the_cell_loads_its_config_mix_and_metrics():
    cell = load_cell(CELL)
    assert cell.config["dataset"]["n_transactions"] == 12773
    assert cell.config["query"] == {"kind": "significant", "pipeline": "three_phase",
                                    "statistic": "fisher"}
    assert cell.traffic["params"] == [{"alpha": 0.05}, {"alpha": 0.01}, {"alpha": 0.001}]
    assert {m["name"] for m in cell.end_to_end} == {"query_s", "query_p95_s", "setup_s"}
    assert {"lamp1_ms", "count_ms", "test_ms", "refilter_ms", "outputs_ms",
            "census_read_ms", "closure_scan_ms"} <= {m["name"] for m in cell.per_layer}


def small_cell():
    """The cell at 48 items x 2,400 transactions (W = 75 words)."""
    cell = load_cell(CELL)
    config = copy.deepcopy(cell.config)
    config["dataset"].update(n_items=48, n_transactions=2400, n_pos=200, density=0.05)
    config["layout"].update(miners=4, expand_batch=32)
    del config["bucket"]
    return dataclasses.replace(cell, config=config)


def test_the_float32_control_fails_the_pvalue_check():
    numbers = control_readings(small_cell(), seed=2**31 + 29)
    assert not judge.passed(numbers)
    assert numbers["pvalue_rel_gap"]["value"] > numbers["pvalue_rel_gap"]["limit"]


def test_a_test_size_run_is_correct_with_the_pipeline_metrics():
    res, checks = run_cell(small_cell(), seed=2**31 + 31, seconds=1.0, trace=True,
                           device="cpu", t_start=time.perf_counter())
    assert res["correct"], checks
    assert checks["pvalue_rel_gap"]["value"] <= 1e-8
    for name in ("lamp1_ms", "count_ms", "test_ms", "refilter_ms", "session_self_ms",
                 "superstep_ms", "roots_ms", "carry_ms", "census_read_ms", "outputs_ms",
                 "closure_readback_ms", "closure_scan_ms"):
        assert res["metrics"][name]["value"] > 0, name
