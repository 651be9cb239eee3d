"""The served cell's per-layer tail: `request_p95_s.served` is the nearest
rank 95th percentile of every request's submission-to-resolution seconds,
a failed request counting as the whole window, and a traced run of the
served driver reports it."""

from __future__ import annotations

import math

import pytest

from chipbench.harness.spec import load_metric
from chipbench.harness.stats import percentile
from chipbench.harness.tracectx import Trace
from chipbench.tests.test_chipbench_spans import traced_run

READ = load_metric("request_p95_s.served")


def test_the_tail_of_every_request_a_failed_one_included():
    # 19 answered requests of 0.01 .. 0.19 s and one failed, counted as a
    # 51 s window: the nearest rank of 95% of 20 is the 19th, 0.19 s
    served = [dict(ok=True, queued_s=0.0, total_s=0.01 * (k + 1)) for k in range(19)]
    served.append(dict(ok=False, queued_s=None, total_s=51.0))
    assert READ(Trace(driver="served", served=served)) == pytest.approx(0.19)
    # two failed of 20: the tail is the window
    served[0] = dict(ok=False, queued_s=None, total_s=51.0)
    assert READ(Trace(driver="served", served=served)) == 51.0


def test_nothing_to_read_off_the_served_driver():
    assert READ(Trace(driver="session")) is None


def test_a_traced_served_run_reports_it(cell_factory, monkeypatch):
    res, tr = traced_run(cell_factory("closed", "served"), monkeypatch)
    value = res["metrics"]["request_p95_s.served"]["value"]
    assert math.isfinite(value) and value > 0.0
    assert value == percentile([r["total_s"] for r in tr.served], 95)
    assert all(r["ok"] for r in tr.served)
