"""The command refuses a machine without a card, and a checkout without
the program; the result line carries the keys the contract names."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from chipbench.harness.cell import run_cell

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
ARGS = ["--workload", "closed_alz_rec_30.queries", "--seed", "3000000001", "--seconds", "2",
        "--trace", "0"]


def _run(cwd: Path, env=None):
    return subprocess.run([sys.executable, "chipbench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, env)
    assert out.returncode == 2
    assert "torch.cuda.is_available() is False" in out.stderr
    assert out.stdout.strip() == ""


def test_with_only_the_benchmark_files_it_exits_nonzero(tmp_path):
    shutil.copytree(BENCH, tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "repro_torch is missing" in out.stderr


@pytest.mark.parametrize("driver,trace", [("session", False), ("session", True),
                                          ("served", False), ("served", True)])
def test_the_result_line_keys(cell_factory, driver, trace):
    cell = cell_factory("significant", driver)
    res, checks = run_cell(cell, seed=2**31 + 3, seconds=1.0, trace=trace, device="cpu",
                           t_start=time.perf_counter())
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks" and res["checks"] == checks
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
        assert all(v["value"] > 0 for v in res["metrics"].values())
    for v in checks.values():
        assert set(v) == {"value", "limit"}
    json.dumps(res)


@pytest.mark.cuda
def test_a_cell_on_the_card_prints_its_line():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run(ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"query_s", "query_p95_s", "setup_s"}
