"""The port's serving layer (`repro_torch.serve`, `ResultStream`) held
against the JAX package's (`repro.serve`, `repro.results.ResultStream`).

Three parts, all on the CPU (`device="cpu"`):

  * stream parity: `build_result_set(..., stream=...)` of both packages on
    the same seeded records gives the same head, fires `on_head` after the
    same number of reconstructed chunks, and returns the same patterns;
  * scheduler parity: one scripted scenario (admission at capacity,
    deadline expiry, cancel, same-signature batching, retry, breaker and
    rebuild, worker death) driven through both packages' schedulers with
    the same instant fake session gives the same outcomes, batch slots,
    sessions, attempts and counters;
  * the real engine: the streamed head equals the final head, a
    concurrency-4 port fleet returns what a direct port run and the JAX
    package's direct run return, and a deadline mid-mine resolves
    "partial".
"""

import asyncio
import math
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
import repro.results as jresults  # noqa: E402
import repro.results.resultset as jresultset  # noqa: E402
import repro.serve as jserve  # noqa: E402
import repro.testing as jtesting  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.results as tresults  # noqa: E402
import repro_torch.results.resultset as tresultset  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
import repro_torch.testing as ttesting  # noqa: E402
from repro.data.synthetic import SyntheticSpec, generate  # noqa: E402
from repro_torch.stats import get_statistic  # noqa: E402

CFG = dict(expand_batch=8)
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    torch's default of one thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(patterns):
    """Each pattern's fields, an untested (NaN) P/q-value as None."""
    def num(x):
        return None if math.isnan(x) else x

    return [(p.items, p.support, p.pos_support, num(p.pvalue), num(p.qvalue))
            for p in patterns]


# ------------------------------------------------------------ stream parity
def seeded_records(seed=0, n=64, m=48, n_rec=90):
    """Records of real itemsets over a random database: occ is the AND of
    the itemset's columns; a third of the records repeat an earlier one (the
    builders' dedup); pos_mask marks the first n/3 transactions."""
    rng = np.random.default_rng(seed)
    w = -(-n // 32)
    dense = rng.random((n, m)) < 0.45
    bits = np.zeros((m, w), dtype=np.uint32)
    for t in range(n):
        bits[dense[t], t // 32] |= np.uint32(1) << np.uint32(t % 32)
    pos_mask = np.zeros(w, dtype=np.uint32)
    n_pos = n // 3
    for t in range(n_pos):
        pos_mask[t // 32] |= np.uint32(1) << np.uint32(t % 32)
    occ = np.zeros((n_rec, w), dtype=np.uint32)
    for r in range(n_rec):
        if r % 3 == 2:
            occ[r] = occ[rng.integers(0, r)]
            continue
        items = rng.choice(m, size=rng.integers(1, 4), replace=False)
        occ[r] = np.bitwise_and.reduce(bits[items], axis=0)
    sup = np.bitwise_count(occ).sum(axis=1).astype(np.int64)
    pos_sup = np.bitwise_count(occ & pos_mask).sum(axis=1).astype(np.int64)
    return occ, sup, pos_sup, bits, n, n_pos


def _streamed(pkg_results, module, monkeypatch, records, *, statistic,
              filter_host, delta, chunk, head_k, **extra):
    """(head keys, chunks reconstructed before on_head, final keys, number
    of on_head calls) of one package's streamed build."""
    occ, sup, pos_sup, bits, n, n_pos = records
    chunks = []
    real = module.reconstruct_closures

    def counting(*a, **kw):
        chunks.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(module, "reconstruct_closures", counting)
    heads = []
    rs = pkg_results.build_result_set(
        occ, sup, pos_sup, bits, n=n, n_pos=n_pos, alpha=0.05, min_sup=1,
        correction_factor=40, delta=delta, filter_host=filter_host,
        statistic=statistic,
        stream=pkg_results.ResultStream(
            head_k=head_k, chunk=chunk,
            on_head=lambda pats: heads.append((_keys(pats), len(chunks)))),
        **extra)
    monkeypatch.setattr(module, "reconstruct_closures", real)
    assert len(heads) == 1, "the head must be delivered exactly once"
    return heads[0][0], heads[0][1], _keys(rs.patterns), rs


@pytest.mark.parametrize("chunk", [1, 7, 256, 1000])
@pytest.mark.parametrize("filter_host", [True, False])
@pytest.mark.parametrize("statistic", ["fisher", "chi2", None])
def test_stream_matches_jax(statistic, filter_host, chunk, monkeypatch):
    records = seeded_records(seed=len(str(statistic)) + chunk)
    occ, sup, pos_sup, bits, n, n_pos = records
    pvals = (get_statistic(statistic).pvalue(sup, pos_sup, n, n_pos)
             if statistic else np.zeros(len(sup)))
    delta = float(np.quantile(pvals, 0.6)) if statistic else float("nan")
    fired = {}
    for head_k in (5, 500):   # 500: more than there are patterns
        kw = dict(statistic=statistic, filter_host=filter_host, delta=delta,
                  chunk=chunk, head_k=head_k)
        want = _streamed(jresults, jresultset, monkeypatch, records, **kw)
        got = _streamed(tresults, tresultset, monkeypatch, records,
                        device="cpu", **kw)
        assert got[:3] == want[:3], (head_k, got[1], want[1])
        assert got[0] == got[2][:head_k]     # the head is the final head
        # and the streamed build is the unstreamed one
        plain = tresults.build_result_set(
            occ, sup, pos_sup, bits, n=n, n_pos=n_pos, alpha=0.05, min_sup=1,
            correction_factor=40, delta=delta, filter_host=filter_host,
            statistic=statistic, device="cpu")
        assert got[3].to_json() == plain.to_json()
        fired[head_k] = got[1]
    if chunk == 1:   # a short head is final before the last record's chunk
        assert fired[5] < fired[500]


@pytest.mark.parametrize("kw, match", [
    (dict(head_k=0), "head_k must be an int >= 1"),
    (dict(head_k=2.0), "head_k must be an int >= 1"),
    (dict(head_k=3, chunk=0), "chunk must be an int >= 1"),
])
def test_result_stream_validation_matches_jax(kw, match):
    msgs = []
    for pkg in (jresults, tresults):
        with pytest.raises(ValueError, match=match) as exc:
            pkg.ResultStream(on_head=print, **kw)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


# --------------------------------------------------------- scheduler parity
class FakeBits:
    nbytes = 64


class FakePacked:
    """The resident words as each fleet reads them: the JAX fleet counts
    `db_bits.nbytes`, the port's `db_dev` (64 bytes both)."""

    db_bits = FakeBits()
    db_dev = torch.zeros(16, dtype=torch.int32)


class FakeDataset:
    def __init__(self, bucket, name):
        self.bucket = bucket
        self.name = name
        self.packed = FakePacked()


class FakeReport:
    cold = False
    query = "significant"


class FakeSession:
    """Instant session recording its runs; `gate`, when given, holds every
    run until set (as tests/test_serve.py's fake does)."""

    def __init__(self, gate=None):
        self.gate = gate
        self.ran = []
        self._lock = threading.Lock()
        self.n_devices = 1
        self.started = threading.Event()

    def run(self, dataset, query, *, stream=None, **kw):
        self.started.set()
        if self.gate is not None:
            assert self.gate.wait(10.0), "test gate never opened"
        with self._lock:
            self.ran.append(dataset.name)
        return FakeReport()

    def has_programs(self, bucket, statistic=None, *, pipeline=None):
        return True

    def warmup(self, target, *, statistic=None, pipeline=None, alpha=None):
        return 0


async def _until(predicate, timeout=5.0):
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    while not predicate():
        if loop.time() - t0 > timeout:
            raise AssertionError("condition never reached")
        await asyncio.sleep(0.005)


def _counters(text: str) -> list[str]:
    """The sample lines of every counter in a Prometheus exposition."""
    names = {line.split()[2] for line in text.splitlines()
             if line.startswith("# TYPE") and line.split()[3] == "counter"}
    return sorted(line for line in text.splitlines()
                  if line and not line.startswith("#")
                  and line.split("{")[0].split()[0] in names)


def _slot(res):
    return (res.outcome, res.batch_size, res.batch_index, res.session_id,
            res.attempts)


async def scripted(serve, testing, api):
    """The scenario on a one-worker fleet, then worker deaths on two."""
    q = api.SignificantPatternQuery(alpha=0.05)
    bucket_a = api.ShapeBucket(transactions=64, positives=32, items=32)
    bucket_b = api.ShapeBucket(transactions=128, positives=32, items=32)
    gate = threading.Event()
    fake = FakeSession(gate)
    sched = serve.Scheduler(serve.SessionFleet([fake]), serve.ServeConfig(
        queue_capacity=5, max_batch=8, max_retries=4, retry_backoff_s=0.005,
        breaker_threshold=3))
    await sched.start()
    out = {}
    first = sched.submit(FakeDataset(bucket_a, "r0"), q)
    await _until(lambda: fake.started.is_set() and sched.depth == 0)
    subs = {name: sched.submit(FakeDataset(b, name), q, **kw) for name, b, kw in (
        ("a0", bucket_a, {}), ("b0", bucket_b, {}), ("a1", bucket_a, {}),
        ("c0", bucket_a, {}), ("d0", bucket_b, {"timeout_s": 0.05}))}
    out["backpressure"] = sched.backpressure
    with pytest.raises(serve.AdmissionError) as full:
        sched.submit(FakeDataset(bucket_a, "over"), q)
    out["rejected"] = full.value.reason
    out["cancel queued"] = sched.cancel(subs["c0"])
    out["cancel running"] = sched.cancel(first)
    out["d0 before gate"] = _slot(await subs["d0"].future)
    gate.set()
    out["r0"] = _slot(await first.future)
    for name, req in subs.items():
        out[name] = _slot(await req.future)
    with testing.injected(testing.FaultPlan(serve_fail_first_n=2)):
        out["retry"] = _slot(await sched.submit(
            FakeDataset(bucket_a, "retry"), q).future)
    rebuilt = []
    orig = sched.fleet.rebuild_worker
    sched.fleet.rebuild_worker = lambda w: (rebuilt.append(w.wid), orig(w))[1]
    with testing.injected(testing.FaultPlan(serve_fail_first_n=3)):
        out["breaker"] = _slot(await sched.submit(
            FakeDataset(bucket_a, "breaker"), q).future)
    out["rebuilt"] = rebuilt
    out["worker"] = (sched.fleet.workers[0].broken,
                     sched.fleet.workers[0].failures)
    # the JAX scheduler's stop() spins if a finished batch's discard
    # callback is still queued; let those callbacks run first (the port's
    # stop() yields on its own, see test_stop_drains_a_finished_batch_whose_
    # discard_is_queued)
    await _until(lambda: not sched._batches, timeout=10)
    await sched.stop()
    with pytest.raises(serve.AdmissionError) as stopped:
        sched.submit(FakeDataset(bucket_a, "late"), q)
    out["after stop"] = stopped.value.reason
    out["ran"] = fake.ran
    out["counters"] = _counters(sched.metrics.expose_text())

    # worker deaths across a two-worker fleet: which request meets which
    # failure depends on the threads' timing, so only order-free totals
    fakes = [FakeSession(), FakeSession()]
    sched = serve.Scheduler(serve.SessionFleet(fakes), serve.ServeConfig(
        queue_capacity=32, max_batch=2, max_retries=4, retry_backoff_s=0.005,
        breaker_threshold=3))
    await sched.start()
    with testing.injected(testing.FaultPlan(serve_fail_first_n=6)):
        reqs = [sched.submit(FakeDataset(bucket_a, f"w{i}"), q)
                for i in range(12)]
        results = await asyncio.gather(*[r.future for r in reqs])
    await _until(lambda: not sched._batches, timeout=10)
    await sched.stop()
    out["deaths"] = (sorted(r.outcome for r in results),
                     sum(r.attempts for r in results),
                     sorted(n for f in fakes for n in f.ran))
    out["deaths counters"] = _counters(sched.metrics.expose_text())
    return out


def test_scheduler_scenario_matches_jax():
    want = asyncio.run(scripted(jserve, jtesting, japi))
    got = asyncio.run(scripted(tserve, ttesting, tapi))
    assert got == want
    # and the scenario did what it scripts
    assert want["rejected"] == "queue_full" and want["backpressure"] == 1.0
    assert want["d0 before gate"][0] == "timeout"
    assert want["c0"][0] == "cancelled" and not want["cancel running"]
    assert [want[n][1:3] for n in ("a0", "a1", "b0")] == [(2, 0), (2, 1), (1, 0)]
    assert want["retry"] == ("ok", 1, 0, 0, 3)
    assert want["breaker"] == ("ok", 1, 0, 0, 4) and want["rebuilt"] == [0]
    assert want["ran"] == ["r0", "a0", "a1", "b0", "retry", "breaker"]
    assert want["deaths"][:2] == (["ok"] * 12, 18)


STOP_RACE = r"""
import asyncio, contextlib
import repro_torch.serve as serve


class Idle:  # a session the scenario never runs
    n_devices = 1


async def main():
    sched = serve.Scheduler(serve.SessionFleet([Idle()]), serve.ServeConfig())
    await sched.start()
    # no dispatcher: stop() then reaches its drain without yielding first
    sched._dispatcher.cancel()
    with contextlib.suppress(asyncio.CancelledError):
        await sched._dispatcher
    sched._dispatcher = None
    woken = asyncio.get_running_loop().create_future()

    async def batch():
        woken.set_result(None)  # queues this coroutine's wakeup first ...

    task = asyncio.create_task(batch())
    sched._batches.add(task)
    task.add_done_callback(sched._batches.discard)  # ... and this after it
    await woken
    assert task.done() and task in sched._batches  # the race, built
    await sched.stop()
    assert not sched._batches
    print("stopped")


asyncio.run(main())
"""


def test_stop_drains_a_finished_batch_whose_discard_is_queued():
    """`Scheduler.stop()` reached while a finished batch task still sits in
    `_batches` (its discard callback queued behind the caller's wakeup)
    returns.  A drain that awaits gather over done tasks never yields to
    the loop and spins, so the scenario runs in a subprocess with a
    timeout of its own."""
    env = dict(os.environ, PYTHONPATH=SRC)
    try:
        r = subprocess.run([sys.executable, "-c", STOP_RACE], env=env,
                           capture_output=True, text=True, timeout=30)
    except subprocess.TimeoutExpired:
        pytest.fail("Scheduler.stop() spun on a finished batch for 30 s")
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.split() == ["stopped"]


def test_port_serve_exports_the_jax_names():
    assert tserve.__all__ == jserve.__all__


def test_fleet_residency_counts_the_jax_bytes():
    """Both fleets count the same bytes for the same dataset, so they make
    the same affinity decisions."""
    db, labels, name = data(seed=1)
    jds = japi.Dataset.from_dense(db, labels, name=name)
    tds = tapi.Dataset.from_dense(db, labels, name=name, device="cpu")
    jw = jserve.FleetWorker(0, FakeSession(), residency_budget_bytes=1 << 20)
    tw = tserve.FleetWorker(0, FakeSession(), residency_budget_bytes=1 << 20)
    assert tw._nbytes(tds) == jw._nbytes(jds) > 0
    assert tw.stream is None      # a CPU (or fake) session has no stream


# -------------------------------------------------------------- real engine
def data(seed=0, n=60, m=24):
    spec = SyntheticSpec(name=f"t{seed}", n_items=m, n_transactions=n,
                         density=0.15, n_pos=20, n_planted=2, seed=seed)
    db, labels, _ = generate(spec)
    return db, labels, spec.name


def test_streamed_head_equals_final_head():
    db, labels, name = data(seed=3)
    session = tapi.MinerSession(device="cpu", runtime=tapi.RuntimeConfig(**CFG))
    ds = tapi.Dataset.from_dense(db, labels, name=name, device="cpu")
    q = tapi.SignificantPatternQuery(alpha=0.05)
    heads = []
    report = session.run(ds, q, stream=tresults.ResultStream(
        head_k=5, on_head=heads.append))
    assert len(heads) == 1, "head must be delivered exactly once"
    assert _keys(heads[0]) == _keys(report.results.patterns[:5])
    again = session.run(ds, q)
    assert report.results.to_json() == again.results.to_json()
    jrep = japi.MinerSession(runtime=japi.RuntimeConfig(**CFG)).run(
        japi.Dataset.from_dense(db, labels, name=name),
        japi.SignificantPatternQuery(alpha=0.05))
    assert _keys(report.results.patterns) == _keys(jrep.results.patterns)


def test_served_concurrency4_parity_with_direct_sessions():
    raw = [data(seed=s) for s in range(6)]
    alphas = (0.05, 0.01, 0.05, 0.01, 0.05, 0.01)
    datasets = [tapi.Dataset.from_dense(db, lab, name=nm, device="cpu")
                for db, lab, nm in raw]
    queries = [tapi.SignificantPatternQuery(alpha=a) for a in alphas]
    direct = tapi.MinerSession(device="cpu", runtime=tapi.RuntimeConfig(**CFG))
    expected = [direct.run(ds, q) for ds, q in zip(datasets, queries)]
    jsession = japi.MinerSession(runtime=japi.RuntimeConfig(**CFG))
    jax_reps = [jsession.run(japi.Dataset.from_dense(db, lab, name=nm),
                             japi.SignificantPatternQuery(alpha=a))
                for (db, lab, nm), a in zip(raw, alphas)]

    async def main():
        heads = []
        svc = tserve.MiningService(
            size=4, device="cpu", runtime=tapi.RuntimeConfig(**CFG),
            warmups=[tserve.WarmupSpec(datasets[0].bucket)])
        await svc.start()
        results = await asyncio.gather(*[
            svc.mine(ds, q, stream=(
                tresults.ResultStream(head_k=3, on_head=heads.append)
                if i == 0 else None))
            for i, (ds, q) in enumerate(zip(datasets, queries))
        ])
        sessions = {w.session.device.type for w in svc.fleet.workers}
        await svc.stop()
        return results, heads, sessions

    results, heads, sessions = asyncio.run(main())
    assert sessions == {"cpu"}
    assert all(r.ok for r in results)
    assert sum(1 for r in results if r.report.cold) == 0
    for exp, jrep, res in zip(expected, jax_reps, results):
        rep = res.report
        for want in (exp, jrep):
            assert (rep.min_sup, rep.correction_factor, rep.delta,
                    rep.n_significant) == (want.min_sup, want.correction_factor,
                                           want.delta, want.n_significant)
            assert _keys(rep.results.patterns) == _keys(want.results.patterns)
    assert len(heads) == 1
    assert _keys(heads[0]) == _keys(results[0].report.results.patterns[:3])


def test_deadline_partial_result_real_engine(tmp_path):
    """A request whose deadline expires mid-mine stops at a superstep
    boundary and resolves "partial": a truncated-but-real ResultSet plus
    the frontier checkpoint path, not a bare timeout."""
    db, labels, name = data(seed=7, n=100, m=40)
    ds = tapi.Dataset.from_dense(db, labels, name=name, device="cpu")
    cfg = tapi.RuntimeConfig(expand_batch=1, steal_enabled=False, ckpt_period=4)
    query = tapi.ClosedFrequentQuery(min_sup=1)

    async def main():
        svc = tserve.MiningService(
            size=1, device="cpu", runtime=cfg,
            config=tserve.ServeConfig(ckpt_root=str(tmp_path)),
            warmups=[tserve.WarmupSpec(ds.bucket, statistic=None)])
        await svc.start()
        res = await svc.mine(ds, query, timeout_s=0.3)
        await svc.stop()
        return res, svc.metrics.expose_text()

    res, metrics = asyncio.run(main())
    assert res.outcome == "partial"
    rep = res.report
    assert rep.partial and not rep.results.complete
    assert len(rep.results.patterns) > 0
    assert res.ckpt_path and res.ckpt_path.startswith(str(tmp_path))
    assert "serve_partial_results_total 1" in metrics


def test_service_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.MiningService(size=2)
