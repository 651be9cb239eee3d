"""The harness finds a configuration, a mix and a metric that arrive as
new files, and the pieces it reduces traces with."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import pytest

from chipbench.harness import profile
from chipbench.harness.cell import run_cell
from chipbench.harness.spec import load_cell, load_metric
from chipbench.harness.stats import percentile
from chipbench.harness.tracectx import span_self_us

BENCH = Path(__file__).resolve().parents[1]
DATA = Path(__file__).resolve().parent / "data"


def test_a_new_config_mix_and_metric_are_found_as_files(tmp_path):
    bench = tmp_path / "chipbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(DATA / "tiny.json", bench / "configs" / "tiny_new.json")
    (bench / "traffic" / "two_cohorts.json").write_text(json.dumps(
        {"driver": "session", "clients": 1, "generator_seeds": [4, 5],
         "params": [{"alpha": 0.05}]}))
    (bench / "metrics" / "requests_read.py").write_text(
        "def read(trace):\n    return float(len(trace.requests)) or None\n")
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_new", "source": "test",
                            "file": "chipbench/configs/tiny_new.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "tiny_new.two", "config": "tiny_new",
                              "traffic": "two_cohorts", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "requests_read", "unit": "requests", "better": "higher",
                              "source": "program_span", "layer": "session",
                              "moves": "query_s", "workloads": ["tiny_new.two"]})
    for m in spec["end_to_end"]:
        if m["name"] in ("query_s", "query_p95_s"):
            m["workloads"].append("tiny_new.two")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = load_cell("tiny_new.two", bench_dir=bench)
    assert cell.config["dataset"]["name"] == "tiny"
    assert [m["name"] for m in cell.per_layer] == ["requests_read"]
    assert {m["name"] for m in cell.end_to_end} == {"query_s", "query_p95_s", "setup_s"}
    res, _ = run_cell(cell, seed=99, seconds=1.5, trace=True, device="cpu",
                      t_start=time.perf_counter())
    assert res["correct"] and res["metrics"]["requests_read"]["value"] >= 1
    res, _ = run_cell(cell, seed=99, seconds=0.5, trace=False, device="cpu",
                      t_start=time.perf_counter())
    assert set(res["metrics"]) == {"query_s", "query_p95_s", "setup_s"}


def test_every_metric_of_the_benchmark_has_its_reader():
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        assert callable(load_metric(m["name"]))
    for w in spec["workloads"]:
        cell = load_cell(w["name"])
        assert cell.end_to_end and cell.per_layer


def test_busy_union_and_idle_gaps():
    iv = [("k1", 0.0, 10.0), ("k2", 5.0, 20.0), ("k3", 40.0, 50.0)]
    assert profile.busy_union_s(iv, 100e-6) == pytest.approx(30e-6)
    assert profile.busy_union_s([], 1.0) is None
    spans = [("phase:lamp1", 0.0, 70.0, 1), ("dispatch", 0.0, 60.0, 1)]
    ops = [("aten::item", 25.0, 35.0, 1)]
    # gaps (20, 40) and (50, 100), each named at its middle
    gaps = profile.idle_gaps(iv, ops, spans, 100e-6)
    assert gaps == [["outside the session > python", pytest.approx(50e-6)],
                    ["dispatch > aten::item", pytest.approx(20e-6)]]
    spans.append(("query:Q", 0.0, 90.0, 2))
    gaps = profile.idle_gaps(iv, ops, spans, 100e-6)
    assert gaps[0] == ["query:Q > python", pytest.approx(50e-6)]
    assert gaps[1] == ["dispatch | query:Q > aten::item", pytest.approx(20e-6)]
    assert profile.top_device_ops(iv)[0] == ["k2", pytest.approx(15e-6)]


def test_bound_is_the_bytes_term_at_the_cells_shapes():
    for b, m, w in ((128, 1191, 22), (512, 1191, 22), (128, 250120, 12), (1, 250120, 12)):
        seconds, by = profile.bound_s(b, m, w)
        assert by == "bytes"
        assert seconds == pytest.approx((m * w + b * w + b * m) * 4 / 3.35e12)
    # several launches: the database once a launch, each row once
    three, _ = profile.bound_s(1 + 40 + 295, 250120, 12, launches=3)
    assert three == pytest.approx(sum(profile.bound_s(b, 250120, 12)[0] for b in (1, 40, 295)))


def test_the_roofline_counts_live_rows_only():
    from chipbench.harness.tracectx import Trace

    read = load_metric("support_count_roofline")
    m, w = 250120, 12
    # two supersteps of a 128-row batch holding 1 and 40 live nodes, and a
    # reconstruction chunk of 128 records at the same shape
    tr = Trace(driver="session", dims=dict(items=m, words=w, transactions=364))
    tr.device = dict(launch_shapes={(128, 262144, 16): 3}, supersteps=2, nodes=41,
                     expand_rows=128,
                     intervals=[("support_count_kernel<64>", 0.0, 100.0),
                                ("support_count_kernel<64>", 200.0, 300.0),
                                ("support_count_kernel<64>", 400.0, 500.0),
                                ("aten::sum", 500.0, 900.0)])
    want = 100.0 * profile.bound_s(1 + 40 + 128, m, w, launches=3)[0] / 300e-6
    assert read(tr) == pytest.approx(want)
    tr.device["supersteps"] = 4          # more supersteps than batch launches
    assert read(tr) is None
    tr.device.update(supersteps=2, intervals=tr.device["intervals"][1:])
    assert read(tr) is None              # the profiler missed a launch


def test_a_per_layer_metric_names_its_cells(tmp_path):
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    del spec["per_layer"][0]["workloads"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises(KeyError, match="lists no workloads"):
        load_cell(spec["workloads"][0]["name"], benchmark=tmp_path / "BENCHMARK.json")


def test_span_self_time_and_percentiles():
    spans = [{"name": "query:Q", "ts": 0.0, "dur": 100.0, "tid": 1},
             {"name": "phase:lamp1", "ts": 10.0, "dur": 30.0, "tid": 1},
             {"name": "dispatch", "ts": 20.0, "dur": 10.0, "tid": 1},
             {"name": "reconstruct", "ts": 60.0, "dur": 20.0, "tid": 1}]
    assert span_self_us(spans, "query:") == pytest.approx(50.0)
    assert percentile([3, 1, 2, 5, 4], 50) == 3
    assert percentile(list(range(1, 21)), 95) == 19
