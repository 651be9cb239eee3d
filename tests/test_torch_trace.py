"""The port's superstep trace ring (repro_torch.obs.trace and the ring in
repro_torch.core.engine) held against the JAX package's, on the CPU.

* decode: the unit cases of tests/test_obs.py, run against the port's copy;
* tracing changes nothing: traced and untraced runs are bit-identical in
  every mode, and the decoded trace equals the JAX package's field for
  field at P = 1 (in-process) and P = 8 (the JAX side in a subprocess with
  eight simulated devices, tests/test_torch_jax_worker.py);
* a wrapped ring warns, counts `trace_dropped` as JAX does, and keeps the
  same most recent window;
* the session: the trace in every phase report, `trace_period` in the
  program cache key, the default ring size, the metrics, and the artifact
  validators (`python -m repro_torch.obs.validate`).

Exact equality is the tolerance throughout.
"""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.api as japi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.data.synthetic import SyntheticSpec, generate  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    DEFAULT_TRACE_CAP,
    N_FIELDS,
    TraceField,
    decode_trace,
    jain_fairness,
)
from repro_torch.obs.trace import expected_samples  # noqa: E402
from repro_torch.obs.validate import (  # noqa: E402
    validate_chrome_trace,
    validate_prometheus_text,
)
from test_torch_jax_worker import TRACE_ARRAYS, run_jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    torch's default of one thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ decode
def make_ring(n_miners, cap, supersteps, period, seed=0):
    """Simulate the engine's ring writes exactly (slot = idx % cap)."""
    rng = np.random.default_rng(seed)
    raw = np.zeros((n_miners, cap, N_FIELDS), np.int32)
    for t in range(supersteps):
        if t % period:
            continue
        idx = t // period
        rec = rng.integers(0, 100, size=(n_miners, N_FIELDS)).astype(np.int32)
        rec[:, TraceField.STEP] = t
        raw[:, idx % cap, :] = rec
    return raw


def check_invariants(tr, n_miners, cap, supersteps, period):
    n_sampled = expected_samples(supersteps, period)
    assert tr.n_steps == min(n_sampled, cap)
    assert tr.dropped == n_sampled - tr.n_steps
    assert tr.n_miners == n_miners
    assert np.all(np.diff(tr.steps) > 0)
    assert np.all(tr.steps % period == 0)
    if tr.dropped:
        assert tr.steps[0] == tr.dropped * period
    for arr in (tr.depth, tr.popped, tr.pushed, tr.closed, tr.emitted,
                tr.donated, tr.received):
        assert arr.shape == (n_miners, tr.n_steps)
    for f in (tr.donation_fairness(), tr.work_fairness()):
        assert 0.0 <= f <= 1.0 + 1e-12
    idle = tr.idle_fraction()
    assert idle.shape == (n_miners,)
    assert np.all((idle >= 0) & (idle <= 1))
    json.dumps(tr.summary())


@pytest.mark.parametrize("n_miners, cap, supersteps, period, steps", [
    (4, 64, 40, 1, list(range(40))),           # no wrap
    (2, 8, 30, 1, list(range(22, 30))),        # wrap keeps the newest window
    (3, 16, 50, 4, list(range(0, 50, 4))),     # sampled period
])
def test_decode_cases(n_miners, cap, supersteps, period, steps):
    raw = make_ring(n_miners, cap, supersteps, period)
    tr = decode_trace(raw, supersteps=supersteps, period=period)
    check_invariants(tr, n_miners, cap, supersteps, period)
    assert tr.steps.tolist() == steps
    assert tr.dropped == len(range(0, supersteps, period)) - len(steps)


def test_decode_rejects_wrong_shape_and_sweeps_invariants():
    with pytest.raises(ValueError, match="expected raw trace"):
        decode_trace(np.zeros((2, 8, N_FIELDS + 1)), supersteps=8, period=1)
    rng = np.random.default_rng(7)
    for _ in range(40):
        n_miners = int(rng.integers(1, 7))
        cap = int(rng.integers(1, 33))
        supersteps = int(rng.integers(0, 121))
        period = int(rng.integers(1, 8))
        raw = make_ring(n_miners, cap, supersteps, period, seed=cap)
        tr = decode_trace(raw, supersteps=supersteps, period=period)
        check_invariants(tr, n_miners, cap, supersteps, period)


def test_decode_equals_jax_decode():
    """The port's decoder is the JAX package's, metrics and all."""
    from repro.obs.trace import decode_trace as jax_decode

    raw = make_ring(3, 8, 37, 2, seed=5)
    names, tiers = ("a", "b", "c"), ("flat", "flat", "cross")
    a = jax_decode(raw, supersteps=37, period=2, round_names=names, round_tiers=tiers)
    b = decode_trace(raw, supersteps=37, period=2, round_names=names, round_tiers=tiers)
    for f in TRACE_ARRAYS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.summary() == b.summary()


def test_jain_fairness():
    assert jain_fairness([1, 1, 1, 1]) == pytest.approx(1.0)
    assert jain_fairness([4, 0, 0, 0]) == pytest.approx(0.25)
    assert jain_fairness([0, 0, 0]) == 1.0
    assert jain_fairness([]) == 1.0
    x = np.random.default_rng(0).integers(0, 50, 16)
    assert 1 / 16 <= jain_fairness(x) <= 1.0


# ------------------------------------------------------------------ engine
def problem(seed=0):
    return generate(SyntheticSpec(name="obs", n_items=24, n_transactions=60,
                                  density=0.15, n_pos=20, n_planted=2, seed=seed))


KW = dict(expand_batch=8, stack_cap=2048, steal_max=32, push_cap=128)
MODES = {"lamp1": {}, "count": dict(min_sup=3),
         "test": dict(min_sup=3, delta=0.01), "count2d": dict(min_sup=3, delta=0.05)}


def port_packed(jp):
    return teng.packed_from_numpy(
        tiles=jp.layout.tiles, m=jp.m, pos_mask=jp.pos_mask, occ0=jp.occ0,
        n=jp.n, n_pos=jp.n_pos, n_pad=jp.n_pad, npos_pad=jp.npos_pad,
        m_pad=jp.m_pad, has_labels=jp.has_labels, device="cpu")


def assert_traces_equal(a, b):
    for f in TRACE_ARRAYS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.period, a.cap, a.dropped) == (b.period, b.cap, b.dropped)


def assert_outputs_equal(a, b):
    """Two MineOutputs of the port equal in everything but the trace."""
    np.testing.assert_array_equal(a.hist, b.hist)
    assert (a.lam_final, a.supersteps, a.sig_count) == (b.lam_final, b.supersteps,
                                                         b.sig_count)
    for name in a.stats:
        if name != "trace_dropped":
            np.testing.assert_array_equal(a.stats[name], b.stats[name], err_msg=name)
    for f in ("hist2d", "sig_occ", "sig_core", "sig_sup", "sig_pos_sup"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_traced_equals_untraced_and_jax_trace_p1(mode):
    """Tracing changes no result, and the decoded trace is the JAX
    package's, field for field and metric for metric."""
    db, labels, _ = problem(seed=0)
    jp = jeng.pack_problem(db, labels)
    tp = port_packed(jp)
    off = teng.mine(packed=tp, mode=mode, cfg=teng.EngineConfig(**KW), **MODES[mode])
    on = teng.mine(packed=tp, mode=mode,
                   cfg=teng.EngineConfig(trace_period=1, trace_cap=1024, **KW),
                   **MODES[mode])
    want = jeng.mine(None, packed=jp, mode=mode, devices=jax.devices()[:1],
                     cfg=jeng.EngineConfig(trace_period=1, trace_cap=1024,
                                           kernel_impl="ref", **KW), **MODES[mode])
    assert_outputs_equal(off, on)
    assert off.trace is None and on.trace is not None
    assert on.trace.n_steps == on.supersteps and on.trace_dropped == 0
    assert_traces_equal(want.trace, on.trace)
    assert want.trace.summary() == on.trace.summary()
    # the decoded volumes reconcile with the cumulative counters
    np.testing.assert_array_equal(on.trace.popped.sum(axis=1), on.stats["popped"])
    np.testing.assert_array_equal(on.trace.closed.sum(axis=1), on.stats["closed"])


def test_ring_wrap_warns_and_counts_as_jax():
    db, labels, _ = problem(seed=0)
    jp = jeng.pack_problem(db, labels)
    cap = 4
    kw = dict(mode="count", min_sup=3)
    with pytest.warns(RuntimeWarning, match="trace ring wrapped"):
        want = jeng.mine(None, packed=jp, devices=jax.devices()[:1],
                         cfg=jeng.EngineConfig(trace_period=1, trace_cap=cap,
                                               kernel_impl="ref", **KW), **kw)
    with pytest.warns(RuntimeWarning, match="trace ring wrapped"):
        got = teng.mine(packed=port_packed(jp),
                        cfg=teng.EngineConfig(trace_period=1, trace_cap=cap, **KW), **kw)
    assert got.trace_dropped == want.trace_dropped == got.supersteps - cap > 0
    np.testing.assert_array_equal(got.stats["trace_dropped"],
                                  want.stats["trace_dropped"])
    assert got.trace.steps.tolist() == list(range(got.supersteps - cap, got.supersteps))
    assert_traces_equal(want.trace, got.trace)


def test_trace_period_validation():
    db, labels, _ = problem(seed=0)
    with pytest.raises(ValueError, match="requires trace_cap"):
        teng.mine(db, labels, mode="count", min_sup=3, device="cpu",
                  cfg=teng.EngineConfig(trace_period=1, **KW))
    with pytest.raises(ValueError, match="trace_period"):
        teng.mine(db, labels, mode="count", min_sup=3, device="cpu",
                  cfg=teng.EngineConfig(trace_period=-1, trace_cap=8, **KW))


@pytest.mark.parametrize("pipeline, period", [("fused23", 1), ("three_phase", 3)])
def test_session_trace_p8_equals_jax(pipeline, period):
    """P = 8, real steal traffic: every phase's decoded trace (sampled every
    `period` supersteps) equals the JAX package's on eight devices."""
    data = dict(name="obs8", n_items=24, n_transactions=60, density=0.15,
                n_pos=20, n_planted=2, seed=3)
    runtime = dict(expand_batch=4, trace_period=period, trace_cap=512)
    want = run_jax(dict(dataset=data, runtime=runtime,
                        query=dict(pipeline=pipeline)), 8)
    db, labels, _ = generate(SyntheticSpec(**data))
    ds = tapi.Dataset.from_dense(db, labels, name="obs8", device="cpu")
    rep = tapi.MinerSession(8, device="cpu", runtime=tapi.RuntimeConfig(**runtime)).run(
        ds, tapi.SignificantPatternQuery(pipeline=pipeline))
    assert rep.results.to_json() == want["results_json"]
    assert len(rep.phases) == len(want["phases"])
    for ph, jph in zip(rep.phases, want["phases"]):
        assert ph.supersteps == jph["supersteps"]
        for f in TRACE_ARRAYS:
            assert np.asarray(getattr(ph.trace, f)).tolist() == jph["trace"][f], f
    assert sum(int(p.trace.donated.sum()) for p in rep.phases) > 0


# ----------------------------------------------------------------- session
def test_session_trace_metrics_and_validators(tmp_path):
    db, labels, _ = problem(seed=2)
    ds = tapi.Dataset.from_dense(db, labels, name="obs", device="cpu")
    session = tapi.MinerSession(1, device="cpu", runtime=tapi.RuntimeConfig(
        trace_period=1, trace_cap=8))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # the ring wraps
        rep = session.mine(ds)
    for p in rep.phases:
        assert p.trace is not None
        assert p.trace.n_steps == min(p.supersteps, 8)
        assert p.trace_dropped == max(p.supersteps - 8, 0)
        assert p.steal_by_round is not None and p.tier_fairness == {"flat": 1.0}
    text = session.metrics.expose_text()
    assert validate_prometheus_text(text) > 0
    assert (f"miner_trace_dropped_total {sum(p.trace_dropped for p in rep.phases)}"
            in text)
    ct = session.tracer.to_chrome_trace()
    assert validate_chrome_trace(ct) > 0
    chrome, prom = tmp_path / "t.json", tmp_path / "m.prom"
    session.tracer.save(str(chrome))
    prom.write_text(text)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.validate", "--chrome", str(chrome),
         "--prom", str(prom)], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("[ok]") == 2
    untraced = tapi.MinerSession(1, device="cpu").mine(ds)
    assert all(p.trace is None for p in untraced.phases)


@pytest.mark.parametrize("bad, match", [
    ({"traceEvents": [{"name": "x", "ph": "XX", "ts": 0}]}, "ph"),
    ("# TYPE m counter\nm{a=\"b\" 1\n", "malformed sample"),
    ("n 1\n", "no preceding TYPE"),
])
def test_validators_reject_malformed(bad, match):
    with pytest.raises(ValueError, match=match):
        if isinstance(bad, dict):
            validate_chrome_trace(bad)
        else:
            validate_prometheus_text(bad)


def test_resolve_default_trace_cap_and_cache_key():
    """trace_period joins the program cache key, and tracing without a cap
    gets the JAX package's default ring."""
    db, labels, _ = problem(seed=2)
    ds = tapi.Dataset.from_dense(db, labels, name="obs", device="cpu")
    jds = japi.Dataset.from_dense(db, labels, name="obs")
    for rt, jrt in ((tapi.RuntimeConfig(trace_period=4), japi.RuntimeConfig(trace_period=4)),
                    (tapi.RuntimeConfig(trace_period=4, trace_cap=128),
                     japi.RuntimeConfig(trace_period=4, trace_cap=128)),
                    (tapi.RuntimeConfig(), japi.RuntimeConfig())):
        got, want = rt.resolve(ds.bucket, 1, "cpu"), jrt.resolve(jds.bucket, 1)
        assert (got.trace_period, got.trace_cap) == (want.trace_period, want.trace_cap)
    assert tapi.RuntimeConfig(trace_period=4).resolve(
        ds.bucket, 1, "cpu").trace_cap == DEFAULT_TRACE_CAP
    session = tapi.MinerSession(1, device="cpu")
    session.run_phase(ds, "count", min_sup=3)
    traced = tapi.MinerSession(1, device="cpu", runtime=tapi.RuntimeConfig(
        trace_period=1, trace_cap=64))
    assert traced._resolve(ds.bucket) != session._resolve(ds.bucket)
    ph = traced.run_phase(ds, "count", min_sup=3)
    assert ph.trace is not None and not ph.cache_hit
    assert session.run_phase(ds, "count", min_sup=3).cache_hit
