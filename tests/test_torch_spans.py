"""The port's host spans beneath the query (repro_torch.obs.span and the
spans the engine, the results layer and the serving layer record), on the
CPU.

* each phase holds exactly `PhaseReport.supersteps` `superstep` spans,
  each with its `expand`, `steal`, `global` and `census.read` inside it on
  one thread, on the classic and the segmented program, for a closed and a
  LAMP query;
* `roots` sits in `pack`, `carry` and `outputs` in `dispatch`, and the
  `closure.*`, `dedup` and `score` spans in `reconstruct`, on the plain
  and the streaming results paths; `roots` counts the roots it dealt and
  `carry` the bytes it uploaded;
* the spans change no result: a ResultSet is bit-identical under the
  default tracer, the no-op tracer and the profiler bridge;
* the ring keeps its newest `max_events` and counts the rest in
  `dropped`, which the session exports as `miner_spans_dropped_total`;
* two fleet workers record `serve.request` spans with distinct request
  ids on distinct OS threads, the query spans inside them;
* the Chrome-trace export carries `epoch_ns` and passes the validator, and
  the spans share the profiler's clock.
"""

import asyncio
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.api as tapi  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch.core.bitmap import supports_np  # noqa: E402
from repro_torch.obs import NULL_TRACER, SpanTracer  # noqa: E402
from repro_torch.obs.validate import validate_chrome_trace  # noqa: E402
from repro_torch.results import ResultStream  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the spans of one superstep of the loop (stealing on)
STEP_CHILDREN = ("expand", "steal", "global", "census.read")
RESULT_SPANS = ("closure.count", "closure.readback", "closure.scan", "dedup", "score")
QUERIES = {
    "closed": tapi.ClosedFrequentQuery(min_sup=6),
    "lamp": tapi.SignificantPatternQuery(alpha=0.05, pipeline="three_phase"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    torch's default of one thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dataset(seed=0, n=40, m=14):
    """Random bits, with three items planted in most positives so that
    the LAMP query finds significant patterns."""
    rng = np.random.default_rng(seed)
    db = rng.random((n, m)) < 0.4
    labels = np.arange(n) < n // 2
    db[: n // 2, :3] |= rng.random((n // 2, 3)) < 0.9
    return tapi.Dataset.from_dense(db, labels, name=f"spans{seed}", device="cpu")


def session(ckpt_period=0, tracer=None, n_miners=4):
    return tapi.MinerSession(n_miners, device="cpu", tracer=tracer,
                             runtime=tapi.RuntimeConfig(ckpt_period=ckpt_period))


def inside(child, parent) -> bool:
    return (child["tid"] == parent["tid"] and parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


def children(events, parent, name):
    return [e for e in events if e["name"] == name and inside(e, parent)]


# ------------------------------------------------------------- the loop
@pytest.mark.parametrize("ckpt_period", [0, 3])
@pytest.mark.parametrize("kind", ["closed", "lamp"])
def test_each_phase_holds_one_superstep_span_per_superstep(kind, ckpt_period):
    s = session(ckpt_period)
    rep = s.run(dataset(), QUERIES[kind])
    ev = s.tracer.events()
    phases = [e for e in ev if e["name"].startswith("phase:")]
    assert [p["name"] for p in phases] == [f"phase:{p.mode}" for p in rep.phases]
    assert all(p.supersteps > 0 for p in rep.phases)
    for span, ph in zip(phases, rep.phases):
        steps = children(ev, span, "superstep")
        assert [e["args"]["t"] for e in steps] == list(range(ph.supersteps))
        assert sum(e["args"]["fired"] for e in steps) == ph.steal_rounds
        for step in steps:
            for name in STEP_CHILDREN:
                assert len(children(ev, step, name)) == 1, name
    n_steps = sum(p.supersteps for p in rep.phases)
    assert sum(e["name"] == "superstep" for e in ev) == n_steps
    assert all(sum(e["name"] == n for e in ev) == n_steps for n in STEP_CHILDREN)


# ------------------------------------------------- spans in their parents
@pytest.mark.parametrize("ckpt_period", [0, 3])
@pytest.mark.parametrize("streamed", [False, True])
def test_spans_sit_in_their_parents(streamed, ckpt_period):
    s = session(ckpt_period)
    heads = []
    stream = ResultStream(head_k=2, on_head=heads.append, chunk=3) if streamed else None
    rep = s.run(dataset(seed=1), QUERIES["closed"], stream=stream)
    assert len(rep.results) > 3 and len(heads) == int(streamed)
    ev = s.tracer.events()
    (pack,), (dispatch,), (recon,) = ([e for e in ev if e["name"] == n]
                                      for n in ("pack", "dispatch", "reconstruct"))
    assert len(children(ev, pack, "roots")) == 1
    for name in ("carry", "outputs"):
        assert len(children(ev, dispatch, name)) == 1, name
    assert len(children(ev, dispatch, "superstep")) == rep.phases[0].supersteps
    for name in RESULT_SPANS:
        got = children(ev, recon, name)
        assert got and len(got) == sum(e["name"] == name for e in ev), name
    n_records = recon["args"]["n_records"]
    reads = children(ev, recon, "closure.readback")
    assert len(reads) == (-(-n_records // 3) if streamed else 1)
    m = dataset(seed=1).packed.m_pad
    assert sum(e["args"]["bytes"] for e in reads) == n_records * m


@pytest.mark.parametrize("ckpt_period", [0, 3])
def test_roots_and_carry_spans_count_the_deal(ckpt_period):
    """`roots` carries `dealt`, the roots the deal gave the miners, and
    `carry` the bytes it uploaded: the dealt rows, far below the dense
    [P, CAP, W] stacks the carry holds."""
    s = session(ckpt_period)
    ds = dataset(seed=1)
    s.run(ds, QUERIES["closed"])
    ev = s.tracer.events()
    (roots,), (carry,) = ([e for e in ev if e["name"] == n] for n in ("roots", "carry"))
    packed = ds.packed
    sup = supports_np(packed.occ0, packed.db_bits)
    dealt = int(((sup != packed.n) & (sup >= QUERIES["closed"].min_sup)).sum())
    assert roots["args"]["dealt"] == dealt > 0
    cap = s._resolve(ds.bucket).stack_cap
    assert 24 * dealt <= carry["args"]["bytes"] < s.n_miners * cap * packed.w_pad * 4


# ------------------------------------------------------ results unchanged
@pytest.mark.parametrize("kind", ["closed", "lamp"])
def test_results_are_identical_under_every_tracer(kind):
    ds = dataset(seed=2)
    got = {}
    for name, tracer in (("default", None), ("none", NULL_TRACER),
                         ("profiler", SpanTracer(torch_profiler=True))):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            got[name] = session(tracer=tracer).run(ds, QUERIES[kind]).results.to_json()
    assert got["default"] == got["none"] == got["profiler"]
    assert json.loads(got["default"])["patterns"]


# ------------------------------------------------------------- the ring
def test_ring_keeps_the_newest_events_and_counts_the_rest():
    tracer = SpanTracer(max_events=1000)
    for i in range(10_000):
        with tracer.span("s", i=i):
            pass
    ev = tracer.events()
    assert len(ev) == 1000 and tracer.dropped == 9000
    assert [e["args"]["i"] for e in ev] == list(range(9000, 10_000))
    tracer.clear()
    assert tracer.events() == [] and tracer.dropped == 9000
    with pytest.raises(ValueError, match="max_events"):
        SpanTracer(max_events=0)


def test_session_exports_the_dropped_spans():
    s = session(tracer=SpanTracer(max_events=8))
    ds = dataset()
    s.run(ds, QUERIES["closed"])
    first = s.tracer.dropped
    assert first > 0
    assert f"miner_spans_dropped_total {first}" in s.metrics.expose_text()
    s.tracer = SpanTracer(max_events=4)      # a new tracer counts from zero
    s.run(ds, QUERIES["closed"])
    total = first + s.tracer.dropped
    assert f"miner_spans_dropped_total {total}" in s.metrics.expose_text()
    s.run(ds, QUERIES["closed"])
    assert s.tracer.dropped > total - first
    assert (f"miner_spans_dropped_total {first + s.tracer.dropped}"
            in s.metrics.expose_text())


# -------------------------------------------------------------- serving
def test_fleet_workers_record_serve_request_spans():
    datasets = [dataset(seed=s) for s in range(3)]
    query = QUERIES["closed"]

    async def main():
        svc = tserve.MiningService(
            size=2, n_miners=2, device="cpu",
            config=tserve.ServeConfig(max_batch=1),
            warmups=[tserve.WarmupSpec(datasets[0].bucket, statistic=None)])
        await svc.start()
        for w in svc.fleet.workers:
            w.session.tracer.clear()
        results = await asyncio.gather(*[svc.mine(datasets[i % 3], query)
                                         for i in range(8)])
        await svc.stop()
        return results, [w.session.tracer.events() for w in svc.fleet.workers]

    results, per_worker = asyncio.run(main())
    assert all(r.ok for r in results)
    tids, rids = [], []
    for wid, ev in enumerate(per_worker):
        reqs = [e for e in ev if e["name"] == "serve.request"]
        assert reqs, f"worker {wid} served nothing"
        assert {e["args"]["worker"] for e in reqs} == {wid}
        assert {e["args"]["attempt"] for e in reqs} == {1}
        tids.append({e["tid"] for e in ev})
        rids += [e["args"]["rid"] for e in reqs]
        queries = [e for e in ev if e["name"].startswith("query:")]
        assert len(queries) == len(reqs)
        assert all(len([q for q in queries if inside(q, r)]) == 1 for r in reqs)
        assert [q["args"]["qid"] for q in queries] == sorted(
            q["args"]["qid"] for q in queries)
    assert sorted(rids) == sorted(set(rids)) and len(rids) == 8
    assert all(len(t) == 1 for t in tids) and tids[0] != tids[1]
    assert threading.get_native_id() not in tids[0] | tids[1]


# --------------------------------------------------- export and the clock
def test_chrome_export_carries_the_epoch_and_validates(tmp_path):
    s = session()
    s.run(dataset(), QUERIES["closed"])
    ct = s.tracer.to_chrome_trace()
    assert ct["otherData"] == {"epoch_ns": s.tracer.epoch_ns}
    assert {e["tid"] for e in ct["traceEvents"]} == {threading.get_native_id()}
    assert validate_chrome_trace(ct) == len(s.tracer.events())
    path = s.tracer.save(str(tmp_path / "t.json"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.validate", "--chrome", path],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("[ok]") == 1


def test_spans_share_the_profilers_clock():
    """Shifted by `epoch_ns` and a mark read on `time.perf_counter_ns`, each
    span lands within 50 us of the `record_function` it entered: the two
    tick as one clock (medians, so one preempted span cannot fail it)."""
    tracer = SpanTracer(torch_profiler=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):       # the first record_function of a profile is slow
            with torch.profiler.record_function("warm"):
                pass
        mark_ns = time.perf_counter_ns()
        with torch.profiler.record_function("mark"):
            pass
        for i in range(50):
            with tracer.span(f"s{i}"):
                torch.ones(64).sum()
            time.sleep(0.0005)
    ev = {e.name: e.time_range for e in prof.events()}
    shift_us = (tracer.epoch_ns - mark_ns) / 1e3 + ev["mark"].start
    starts = [sp["ts"] + shift_us - ev[sp["name"]].start for sp in tracer.events()]
    ends = [sp["ts"] + sp["dur"] + shift_us - ev[sp["name"]].end
            for sp in tracer.events()]
    assert abs(statistics.median(starts)) < 50.0
    assert abs(statistics.median(ends)) < 50.0
