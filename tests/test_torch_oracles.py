"""The port held against the JAX package on the CPU: its queries against
the sequential oracles (`repro.core.lcm`, `repro.core.lamp`), its copies
of those oracles (`repro_torch.core.lcm`, `.lamp`), its statistics and its
observability against the JAX package's own.

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
import repro_torch.core.lamp as tlamp  # noqa: E402
import repro_torch.core.lcm as tlcm  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.stats as tstats  # noqa: E402
from repro_torch.core.bitmap import full_occ, pack_db  # noqa: E402
from repro_torch.data.synthetic import SyntheticSpec, generate  # noqa: E402

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


def _fisher_batch(kind, N, N_pos):
    """(x, n) for `test_fisher_pvalue_batches_bit_equal`: a few thousand
    valid cells drawn from ~150 with heavy repetition, in shuffled order;
    2,000 distinct cells; the root's scalar (N, N_pos); or nothing."""
    rng = np.random.default_rng(7)
    if kind == "scalar":
        return N, N_pos
    if kind == "empty":
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    # supports over the whole range and up to 2 N_pos; n anywhere in its range
    x = np.concatenate([rng.integers(0, N + 1, 3000),
                        rng.integers(0, min(N, 2 * N_pos) + 1, 3000)])
    lo, hi = np.maximum(0, x - (N - N_pos)), np.minimum(x, N_pos)
    n = lo + (rng.random(x.size) * (hi - lo + 1)).astype(np.int64)
    _, first = np.unique(x * (N_pos + 1) + n, return_index=True)
    x, n = x[np.sort(first)][:2000], n[np.sort(first)][:2000]
    if kind == "repeated":
        pick = rng.integers(0, 150, 4000)
        x, n = x[pick], n[pick]
    return x, n


@pytest.mark.parametrize("kind", ["repeated", "distinct", "scalar", "empty"])
@pytest.mark.parametrize("margins", [(12773, 1129), (364, 176)])
def test_fisher_pvalue_batches_bit_equal(kind, margins):
    """The port's Fisher P-value evaluates each distinct (x, n) pair once,
    from log-binomial tables, and scatters back in the input's order: it
    equals the JAX package's, which builds the whole matrix, bit for bit,
    at `mcf7`'s margins and at alz_rec_30's."""
    N, N_pos = margins
    x, n = _fisher_batch(kind, N, N_pos)
    got = tstats.get_statistic("fisher").pvalue(x, n, N, N_pos)
    want = jstats.get_statistic("fisher").pvalue(x, n, N, N_pos)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if kind == "repeated":
        assert len(set(zip(x.tolist(), n.tolist()))) <= 150 < len(x)


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


# ------------------------------------------- the sequential oracles, copied


def small_db(seed):
    """A database of tests/test_lcm.py's strategy (4-40 transactions, 2-10
    items, density 0.05-0.8), drawn from a seed."""
    rng = np.random.default_rng(seed)
    n, m = int(rng.integers(4, 41)), int(rng.integers(2, 11))
    return rng.random((n, m)) < rng.uniform(0.05, 0.8)


def labelled_db(seed):
    """A labelled database of tests/test_lamp.py's strategy."""
    rng = np.random.default_rng(seed)
    n, m = int(rng.integers(10, 49)), int(rng.integers(3, 10))
    db = rng.random((n, m)) < rng.uniform(0.1, 0.7)
    labels = np.zeros(n, dtype=bool)
    labels[rng.choice(n, size=int(rng.integers(2, n - 1)), replace=False)] = True
    return db, labels


def _stats(s):
    return (s.nodes_popped, s.nodes_rejected, s.closed_found, s.max_stack, s.supports_gemv)


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("min_sup", [1, 3, 6])
def test_port_lcm_equals_jax_lcm(seed, min_sup):
    """`lcm_closed` and `brute_force_closed`: the same closed sets in the
    same order with the same stats; `closure_np` the same items."""
    db = small_db(seed)
    got, gst = tlcm.lcm_closed(db, min_sup=min_sup)
    want, wst = jlcm.lcm_closed(db, min_sup=min_sup)
    assert got == want and _stats(gst) == _stats(wst)
    assert tlcm.brute_force_closed(db, min_sup) == jlcm.brute_force_closed(db, min_sup)
    bits = pack_db(db)
    occ = full_occ(db.shape[0]) & bits[0]
    np.testing.assert_array_equal(tlcm.closure_np(occ, bits), jlcm.closure_np(occ, bits))


def test_port_lcm_min_sup_filters_as_jax():
    """tests/test_lcm.py::test_min_sup_filters's database."""
    db = np.random.default_rng(2).random((30, 8)) < 0.4
    for ms in [1, 2, 4, 8]:
        assert tlcm.lcm_closed(db, min_sup=ms)[0] == jlcm.lcm_closed(db, min_sup=ms)[0]


def _lamp_fields(res):
    return (res.n_transactions, res.n_pos, res.alpha, res.lambda_final, res.min_sup,
            res.correction_factor, res.delta,
            [(s.items, s.support, s.pos_support, s.pvalue) for s in res.significant],
            _stats(res.phase1_stats), _stats(res.phase2_stats))


@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("alpha", [0.01, 0.05, 0.2])
@pytest.mark.parametrize("statistic", ["fisher", "chi2"])
def test_port_lamp_equals_jax_lamp(seed, alpha, statistic):
    """`lamp` and `lamp_phase1` field for field, P-values exactly."""
    db, labels = labelled_db(seed)
    got = tlamp.lamp(db, labels, alpha=alpha, statistic=statistic)
    want = jlamp.lamp(db, labels, alpha=alpha, statistic=statistic)
    assert _lamp_fields(got) == _lamp_fields(want)
    n_pos = int(labels.sum())
    g1 = tlamp.lamp_phase1(db, n_pos, alpha, statistic)
    w1 = jlamp.lamp_phase1(db, n_pos, alpha, statistic)
    assert g1[:2] == w1[:2] and _stats(g1[2]) == _stats(w1[2])


def test_port_lamp_planted_and_null_data_as_jax():
    """tests/test_lamp.py's planted-pattern and null-data cases."""
    spec = SyntheticSpec(name="t", n_items=40, n_transactions=120, density=0.08,
                         n_pos=40, n_planted=2, planted_pos_rate=0.8,
                         planted_neg_rate=0.02, seed=7)
    db, labels, _ = generate(spec)
    got = tlamp.lamp(db, labels, alpha=0.05)
    assert got.significant and _lamp_fields(got) == _lamp_fields(
        jlamp.lamp(db, labels, alpha=0.05))
    rng = np.random.default_rng(3)
    for _ in range(30):
        db = rng.random((40, 7)) < 0.3
        labels = np.zeros(40, dtype=bool)
        labels[rng.choice(40, size=15, replace=False)] = True
        assert _lamp_fields(tlamp.lamp(db, labels)) == _lamp_fields(jlamp.lamp(db, labels))


def test_port_phase1_state_and_thresholds():
    """`Phase1State` moves lambda as JAX's does, and the port's Tarone
    count thresholds are the JAX package's."""
    a, b = tlamp.Phase1State(48, 16, 0.05), jlamp.Phase1State(48, 16, 0.05)
    for sup in [48, 30, 30, 12, 12, 12, 9, 40, 25]:
        assert a.observe(sup) == b.observe(sup)
    np.testing.assert_array_equal(a.cnt, b.cnt)
    np.testing.assert_array_equal(tstats.lamp_count_thresholds(48, 16, 0.05),
                                  jstats.lamp_count_thresholds(48, 16, 0.05))
