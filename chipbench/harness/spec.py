"""Cells from `BENCHMARK.json`, and the files each name brings.

A cell (an entry of `workloads`) names a configuration and a traffic mix;
the harness reads `configs/<config>.json` and `traffic/<traffic>.json`
under this folder, and each per-layer metric the cell reports from
`metrics/<metric>.py`.  A new configuration, mix or metric is a new file
and a new entry: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

__all__ = ["BENCH_DIR", "ROOT", "Cell", "load_cell", "load_metric"]


@dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple[dict, ...]   # the metrics this cell reports untraced
    per_layer: tuple[dict, ...]    # ... and traced
    bench_dir: Path = BENCH_DIR    # where its files were found


def _layer_cells(metric: dict) -> list:
    if "workloads" not in metric:
        raise KeyError(f"per-layer metric {metric['name']!r} lists no workloads")
    return metric["workloads"]


def load_cell(name: str, bench_dir: Path = BENCH_DIR,
              benchmark: Path | None = None) -> Cell:
    """The cell `name` of `BENCHMARK.json` with its configuration and mix."""
    benchmark = benchmark or bench_dir.parent / "BENCHMARK.json"
    spec = json.loads(benchmark.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {benchmark}; have {sorted(cells)}")
    w = cells[name]
    config = json.loads((bench_dir / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    # an end-to-end metric without `workloads` is every cell's
    e2e = tuple(m for m in spec["end_to_end"] if name in m.get("workloads", [name]))
    per_layer = tuple(m for m in spec["per_layer"] if name in _layer_cells(m))
    return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=e2e, per_layer=per_layer, bench_dir=bench_dir)


def load_metric(name: str, bench_dir: Path = BENCH_DIR):
    """`read(trace) -> float | None` of `metrics/<name>.py`."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"chipbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
