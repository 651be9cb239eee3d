"""The cluster driver on the CPU: a test-size cell across 2 gloo processes.

Its answers equal the session driver's bit for bit on the same seed and
miners; a traced run reads `collective_ms`; a timed path broken in every
rank (an answer altered, half the batch left out, the exchange between
processes left out) comes out as not correct; ranks that share a card or
hold JAX fail the run; and a follower that dies mid-window ends the run
within the watchdog's limit, with no result and no process left behind.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from chipbench.harness import cell as cell_mod
from chipbench.harness import cluster
from chipbench.harness.cluster import cluster_faults
from chipbench.harness.spec import load_cell, load_metric
from chipbench.tests import planted

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
DATA = Path(__file__).resolve().parent / "data"
SEED = 2**31 + 41
ANSWER_OF = cell_mod.answer_of


#: the per-layer metric of the processes layer, as a cell of the mix lists it
COLLECTIVE_MS = {"name": "collective_ms", "unit": "ms", "better": "lower",
                 "source": "program_counter", "layer": "processes", "moves": "query_s",
                 "workloads": ["tiny.cluster"]}


def cluster_cell(processes: int = 2):
    """The mix `alpha_sweep_cluster4` at test size: the tiny LAMP
    configuration (4 miners) across `processes` ranks, reporting what
    `lamp_mcf7.queries` reports (but the replay share: a group runs every
    superstep eagerly) and `collective_ms`."""
    base = load_cell("lamp_mcf7.queries")
    config = json.loads((DATA / "tiny.json").read_text())
    mix = json.loads((BENCH / "traffic" / "alpha_sweep_cluster4.json").read_text())
    traffic = dict(mix, generator_seeds=[0, 1], processes=processes,
                   params=[{"alpha": 0.05}, {"alpha": 0.01}])
    per_layer = tuple(m for m in base.per_layer if m["name"] != "superstep_replay_pct")
    return dataclasses.replace(base, name="tiny.cluster", traffic_name="alpha_sweep_cluster4",
                               config=config, traffic=traffic, chips=processes,
                               per_layer=per_layer + (COLLECTIVE_MS,))


def _run(cell, trace=False, seconds=1.0, seed=SEED):
    return cell_mod.run_cell(cell, seed=seed, seconds=seconds, trace=trace, device="cpu",
                             t_start=time.perf_counter())


def _recording(monkeypatch):
    """Every answer run_cell judges, by request, in order."""
    seen: dict = {}

    def recording(report):
        ans = ANSWER_OF(report)
        seen.setdefault(json.dumps(ans, sort_keys=True), ans)
        return ans

    monkeypatch.setattr(cell_mod, "answer_of", recording)
    return seen


def test_the_answers_equal_the_session_drivers(monkeypatch):
    c = cluster_cell()
    one = dataclasses.replace(c, traffic={k: v for k, v in c.traffic.items()
                                          if k != "processes"} | {"driver": "session"})
    got_one = _recording(monkeypatch)
    res, _ = _run(one, seconds=4.0)
    assert res["correct"], res
    got_cluster = _recording(monkeypatch)
    res, _ = _run(c, seconds=4.0)
    assert res["correct"] and res["failed"] == 0, res
    assert res["device"]["count"] == 1 and res["attempted"] >= 2
    # the distinct answers of both runs, P- and q-values bit for bit: one
    # for each request of the mix (dataset i % 2 at alpha i % 2)
    assert len(got_cluster) == len(got_one) == 2
    assert got_cluster.keys() == got_one.keys()


def test_a_traced_run_reads_the_collectives():
    c = cluster_cell()
    res, _ = _run(c, trace=True, seconds=2.0)
    assert res["correct"], res
    assert res["metrics"]["collective_ms"]["value"] > 0
    assert set(res["metrics"]) <= {m["name"] for m in c.per_layer}
    for name in ("session_self_ms", "superstep_ms", "loop_step_ms", "census_read_ms",
                 "outputs_ms", "reconstruct_ms"):
        assert res["metrics"][name]["value"] > 0, name


def test_the_reader_takes_the_median_and_reads_nothing_without_a_group():
    from chipbench.harness.tracectx import Trace

    read = load_metric("collective_ms")
    reqs = [dict(wall_s=1.0, supersteps=1, spans=[], collective_s=s) for s in (0.3, 0.1, 0.2)]
    assert read(Trace(driver="session", requests=reqs)) == pytest.approx(200.0)
    alone = [dict(wall_s=1.0, supersteps=1, spans=[])]
    assert read(Trace(driver="session", requests=alone)) is None


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch", "no_exchange"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    monkeypatch.setenv(planted.FAULT_ENV, fault)
    monkeypatch.setattr(cluster, "RANK_MODULE", "chipbench.tests.planted")
    planted.plant(fault, monkeypatch.setattr)
    res, checks = _run(cluster_cell())
    assert not res["correct"]
    assert checks["wrong_answers"]["value"] >= 1


@pytest.mark.parametrize("fault,message", [("same_card", "share the card"),
                                           ("hold_jax", r"rank 1 holds \['jax'\]")])
def test_ranks_on_one_card_or_holding_jax_fail_the_run(monkeypatch, fault, message):
    monkeypatch.setenv(planted.FAULT_ENV, fault)
    monkeypatch.setattr(cluster, "RANK_MODULE", "chipbench.tests.planted")
    if fault not in planted.FOLLOWERS_ONLY:
        planted.plant(fault, monkeypatch.setattr)
    with pytest.raises(RuntimeError, match=message):
        _run(cluster_cell())


def test_the_checks_reject_fakes():
    ok = [dict(rank=r, card=f"GPU-{r}", peak=1, forbidden=[]) for r in range(4)]
    assert cluster_faults(ok) == []
    assert cluster_faults([dict(r, card=None) for r in ok]) == []   # the CPU
    shared = [dict(r, card="GPU-0" if r["rank"] in (0, 2) else r["card"]) for r in ok]
    assert cluster_faults(shared) == ["ranks [0, 2] share the card GPU-0"]
    held = [dict(r, forbidden=["jax", "repro"] if r["rank"] == 3 else []) for r in ok]
    assert cluster_faults(held) == ["rank 3 holds ['jax', 'repro']"]


def _planted_ranks(marker: str) -> list[int]:
    """Processes still running a planted rank whose spec holds `marker`."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            cmd = Path(f"/proc/{pid}/cmdline").read_bytes().decode(errors="replace")
        except OSError:
            continue
        if "chipbench.tests.planted" in cmd and marker in cmd:
            out.append(int(pid))
    return out


def test_a_follower_that_dies_ends_the_run_within_the_watchdogs_limit():
    seed = SEED + int(time.time()) % 100000
    window = 60.0
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "from chipbench.harness import cluster\n"
        "from chipbench.harness.cell import run_cell\n"
        "from chipbench.tests.test_chipbench_cluster import cluster_cell\n"
        "cluster.RANK_MODULE = 'chipbench.tests.planted'\n"
        "res, _ = run_cell(cluster_cell(), seed=%d, seconds=%r, trace=False, device='cpu',"
        " t_start=time.perf_counter())\n"
        "print('RESULT', res['correct'])\n" % (str(ROOT / "src"), str(ROOT), seed, window))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, cwd=ROOT, env=dict(os.environ, **{planted.FAULT_ENV: "die"}))
    took = time.perf_counter() - t0
    assert out.returncode != 0, out.stdout
    assert "RESULT" not in out.stdout
    assert "rank 1 exited" in out.stderr or "Connection" in out.stderr, out.stderr[-3000:]
    assert took < window / 2, took
    time.sleep(1.0)
    assert _planted_ranks(f'"seed": {seed}') == []
