"""The port held against the JAX package on the CPU: its queries against
the sequential oracles (`repro.core.lcm`, `repro.core.lamp`), its
statistics and its observability against the JAX package's own.

The host float64 P-values are copies of the JAX package's numpy code, so
they must agree exactly.  The device float32 P-values (torch `lgamma` /
`log_ndtr` against JAX's `gammaln` / `log_ndtr`) agree within a tolerance
set from float32 rounding: both work in log space, where the largest term
is log Gamma(N + 1), so the two logs may differ by a few float32 ulps of
it; the tests allow 4 of them.
"""

import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from scipy.special import gammaln  # noqa: E402

import repro.core.lamp as jlamp  # noqa: E402
import repro.core.lcm as jlcm  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro.stats as jstats  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.stats as tstats  # noqa: E402

#: float32 unit roundoff
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    torch's default of one thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_db(seed, n=40, m=14, density=0.3, n_pos=15):
    rng = np.random.default_rng(seed)
    db = rng.random((n, m)) < density
    labels = np.zeros(n, bool)
    labels[rng.choice(n, n_pos, replace=False)] = True
    return db, labels


@pytest.fixture(scope="module")
def session():
    return tapi.MinerSession(1, device="cpu")


def dataset(db, labels):
    return tapi.Dataset.from_dense(db, labels, device="cpu")


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("min_sup", [1, 4])
def test_closed_frequent_matches_sequential_oracles(seed, min_sup, session):
    """The port's closed-frequent query lists exactly the closed sets that
    the JAX package's sequential LCM and its brute-force enumeration find."""
    db, _ = random_db(seed)
    rep = session.run(dataset(db, None), tapi.ClosedFrequentQuery(min_sup=min_sup))
    got = {(frozenset(p.items), p.support) for p in rep.results}
    want = jlcm.brute_force_closed(db, min_sup)
    assert got == set(want.items())
    closed, _ = jlcm.lcm_closed(db, min_sup)
    assert got == set(closed)
    assert rep.n_significant == len(rep.results) == len(want)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("statistic", ["fisher", "chi2"])
def test_significant_query_matches_sequential_lamp(seed, statistic, session):
    """Both pipelines of the port against the JAX package's sequential LAMP:
    the same lambda, min_sup, correction factor and delta, and the same
    significant patterns with the same float64 P-values (the oracle sums
    its own P-values, hence the 1e-12).  three_phase gates at delta in
    float32 on the device, so a pattern whose P-value lies within
    float32's reach of delta may part; none does on these inputs."""
    db, labels = random_db(seed, m=16, density=0.35)
    ref = jlamp.lamp(db, labels, alpha=0.05, statistic=statistic)
    want = {tuple(sorted(s.items)): (s.support, s.pos_support, s.pvalue)
            for s in ref.significant}
    for pipeline in ("three_phase", "fused23"):
        rep = session.run(dataset(db, labels), tapi.SignificantPatternQuery(
            alpha=0.05, statistic=statistic, pipeline=pipeline))
        assert (rep.lambda_final, rep.min_sup, rep.correction_factor, rep.delta) == (
            ref.lambda_final, ref.min_sup, ref.correction_factor, ref.delta)
        got = {p.items: (p.support, p.pos_support, p.pvalue) for p in rep.results}
        assert got.keys() == want.keys()
        for items, (sup, pos, pv) in got.items():
            assert (sup, pos) == want[items][:2]
            assert pv == pytest.approx(want[items][2], rel=1e-12)
        assert rep.n_significant == len(want)


def _cells(N, N_pos, seed=0, size=4000):
    """Random valid (x, n) cells of the 2x2 table, plus the whole grid
    where it is small, and the Tarone-bound edge n = min(x, N_pos)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, N + 1, size)
    n = np.minimum(rng.integers(0, N_pos + 1, size), x)
    n = np.maximum(n, x - (N - N_pos))        # a valid 2x2 table
    edge = np.arange(N + 1)
    xs, ns = [x, edge], [n, np.minimum(edge, N_pos)]
    if (N + 1) * (N_pos + 1) <= 5000:
        grid_x, grid_n = np.meshgrid(np.arange(N + 1), np.arange(N_pos + 1))
        keep = (grid_n <= grid_x) & (grid_x - grid_n <= N - N_pos)
        xs.append(grid_x[keep])
        ns.append(grid_n[keep])
    return np.concatenate(xs), np.concatenate(ns)


@pytest.mark.parametrize("statistic", ["fisher", "chi2"])
@pytest.mark.parametrize("margins", [(48, 16), (697, 105), (364, 176), (60, 1)])
def test_host_pvalues_and_thresholds_bit_equal(statistic, margins):
    N, N_pos = margins
    x, n = _cells(N, N_pos)
    js, ts = jstats.get_statistic(statistic), tstats.get_statistic(statistic)
    np.testing.assert_array_equal(ts.pvalue(x, n, N, N_pos), js.pvalue(x, n, N, N_pos))
    xs = np.arange(N + 1)
    np.testing.assert_array_equal(ts.min_attainable_pvalue(xs, N, N_pos),
                                  js.min_attainable_pvalue(xs, N, N_pos))
    for alpha in (0.05, 0.01):
        np.testing.assert_array_equal(ts.count_thresholds(N, N_pos, alpha),
                                      js.count_thresholds(N, N_pos, alpha))


@pytest.mark.parametrize("statistic", ["fisher", "chi2"])
@pytest.mark.parametrize("margins", [(48, 16), (697, 105), (364, 176)])
def test_device_pvalues_within_float32_tolerance(statistic, margins):
    N, N_pos = margins
    x, n = _cells(N, N_pos, seed=1)
    want = np.asarray(jstats.get_statistic(statistic).pvalue_device(
        jnp.asarray(x, jnp.int32), jnp.asarray(n, jnp.int32), N, N_pos,
        k_max=N_pos + 7), dtype=np.float64)
    got = tstats.get_statistic(statistic).pvalue_device(
        torch.from_numpy(x.astype(np.int32)), torch.from_numpy(n.astype(np.int32)),
        N, N_pos, k_max=N_pos + 7).double().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    # log-space tolerance: 4 float32 ulps of the largest term, log Gamma(N+1)
    tol = 4 * EPS32 * float(gammaln(N + 1))
    # below the float32 clip (exp(-87)) both sides hold the clip value
    live = (want > 1e-36) & (got > 1e-36)
    assert np.all((want > 1e-36) == (got > 1e-36))
    dlog = np.abs(np.log(got[live]) - np.log(want[live]))
    assert dlog.max() <= tol, (dlog.max(), tol)
    # and both stay within the same tolerance of the exact float64 value
    exact = tstats.get_statistic(statistic).pvalue(x, n, N, N_pos)
    assert np.abs(np.log(got[live]) - np.log(exact[live])).max() <= tol


# ------------------------------------------------------------ observability
def _drive_metrics(obs):
    reg = obs.MetricsRegistry()
    c = reg.counter("hits_total", "cache hits")
    g = reg.gauge("programs", "cached programs")
    h = reg.histogram("query_seconds", "latency", labels=("query",))
    h2 = reg.histogram("phase_seconds", "phase latency", buckets=(0.1, 1.0))
    c.inc()
    c.inc(2)
    g.set(3)
    for v in (0.0004, 0.02, 0.3, 7.0, 100.0):
        h.labels(query="significant").observe(v)
    h.labels(query="topk").observe(0.05)
    h2.observe(0.5)
    assert reg.counter("hits_total", "cache hits") is c
    return reg.expose_text()


def test_metrics_exposition_matches_jax():
    assert tobs.DEFAULT_LATENCY_BUCKETS == jobs.DEFAULT_LATENCY_BUCKETS
    assert _drive_metrics(tobs) == _drive_metrics(jobs)


def test_jsonl_logger_matches_jax():
    records = []
    for obs in (jobs, tobs):
        buf = io.StringIO()
        obs.JsonlLogger(buf, clock=lambda: 12.5).event(
            "phase", mode="count", wall_s=0.25, blob=object)
        records.append(json.loads(buf.getvalue()))
    assert records[0] == records[1]


@pytest.mark.parametrize("profiler", [False, True])
def test_span_tracer_events(profiler, tmp_path):
    tracer = tobs.SpanTracer(torch_profiler=profiler)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) \
            as prof:
        with tracer.span("query", dataset="d"):
            with tracer.span("phase:count", mode="count", bucket=(1, 2)):
                torch.ones(4).sum()
    ev = tracer.events()
    assert [e["name"] for e in ev] == ["phase:count", "query"]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in ev)
    assert ev[0]["args"] == {"mode": "count", "bucket": "(1, 2)"}
    assert ev[1]["ts"] <= ev[0]["ts"]
    names = {e.key for e in prof.key_averages()}
    assert ("phase:count" in names) == profiler
    path = tracer.save(str(tmp_path / "t.json"))
    with open(path) as f:
        assert json.load(f) == tracer.to_chrome_trace()
    tracer.clear()
    assert tracer.events() == []
