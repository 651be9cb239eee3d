"""A run with the timed path broken underneath comes out as not correct:
an answer altered where it is produced, and half of each superstep's
batch left out of the support count.  (One card: no exchange between
chips to leave out; a superstep that returns its state unchanged never
ends the query, so no answer comes at all.)"""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from chipbench.harness.cell import run_cell


def _altered(build):
    def build_result_set(*args, **kw):
        res = build(*args, **kw)
        if res.patterns:
            p = res.patterns[0]
            res.patterns[0] = dataclasses.replace(p, support=p.support + 1)
        return res
    return build_result_set


def _half_batch(count):
    def support_counts_tiled(occ, db_tiles, **kw):
        s = count(occ, db_tiles, **kw)
        s[s.shape[0] // 2:] = 0
        return s
    return support_counts_tiled


@pytest.mark.parametrize("driver", ["session", "served"])
@pytest.mark.parametrize("kind", ["significant", "closed"])
@pytest.mark.parametrize("fault", ["answer_altered", "half_batch"])
def test_a_broken_timed_path_is_not_correct(cell_factory, monkeypatch, driver, kind, fault):
    import repro_torch.core.expand as expand
    import repro_torch.results as results

    if fault == "answer_altered":
        monkeypatch.setattr(results, "build_result_set", _altered(results.build_result_set))
    else:
        monkeypatch.setattr(expand, "support_counts_tiled",
                            _half_batch(expand.support_counts_tiled))
    cell = cell_factory(kind, driver)
    res, checks = run_cell(cell, seed=2**31 + 29, seconds=1.0, trace=False, device="cpu",
                           t_start=time.perf_counter())
    assert not res["correct"]
    assert checks["wrong_answers"]["value"] >= 1


def test_the_unbroken_path_is_correct(cell_factory):
    res, _ = run_cell(cell_factory("closed"), seed=2**31 + 29, seconds=1.0, trace=False,
                      device="cpu", t_start=time.perf_counter())
    assert res["correct"]
    assert torch.get_num_threads() >= 1
