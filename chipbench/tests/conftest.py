"""Shared set-up of the benchmark's CPU tests: the repository's root and
`src/` on the path, and small cells that run in seconds on the CPU."""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

DATA = Path(__file__).resolve().parent / "data"


def tiny_cell(kind: str = "significant", driver: str = "session"):
    """A cell of the benchmark with a test-size configuration and mix."""
    from chipbench.harness.spec import load_cell

    base = load_cell({"session": "closed_alz_rec_30.queries",
                      "served": "closed_alz_rec_30.served"}[driver])
    name = "tiny" if kind == "significant" else "tiny_closed"
    config = json.loads((DATA / f"{name}.json").read_text())
    params = ([{"alpha": 0.05}, {"alpha": 0.01}] if kind == "significant"
              else [{"min_sup": 12}, {"min_sup": 14}])
    traffic = dict(base.traffic, generator_seeds=[0, 1, 2], params=params)
    return dataclasses.replace(base, config=config, traffic=traffic)


@pytest.fixture
def cell_factory():
    return tiny_cell
