"""The port's fault tolerance held against the JAX package's, on the CPU:
kill-and-resume bit-identity, elastic resharding, provenance refusal,
corrupt-step fallback and cooperative partial results (DESIGN.md §11).

A "kill" is a `SimulatedFault` raised at a segment boundary
(`repro_torch.testing.faults`); "fewer miners" is a fresh `MinerSession`
with fewer virtual miners.  A soft stop is compared with the JAX package's
at the same stop point, report field for report field.  Exact equality is
the tolerance throughout: ResultSets are compared by their JSON export,
which carries every float64 P- and q-value.
"""

import math
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.api as japi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro.data.synthetic import SyntheticSpec, generate  # noqa: E402
from repro_torch.api import (  # noqa: E402
    ClosedFrequentQuery,
    Dataset,
    MinerSession,
    RuntimeConfig,
    SignificantPatternQuery,
    TopKSignificantQuery,
)
from repro_torch.ckpt.mining import ProvenanceMismatch  # noqa: E402
from repro_torch.obs.validate import validate_prometheus_text  # noqa: E402
from repro_torch.results import ResultStream  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    FaultPlan,
    SimulatedFault,
    corrupt_step_dir,
    injected,
)

CKPT_CFG = dict(expand_batch=4, ckpt_period=2)
Q = SignificantPatternQuery(alpha=0.05)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    torch's default of one thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def data(seed=0, n=60, m=24):
    spec = SyntheticSpec(name=f"ft{seed}", n_items=m, n_transactions=n,
                         density=0.15, n_pos=20, n_planted=2, seed=seed)
    db, labels, _ = generate(spec)
    return db, labels, spec.name


def small_dataset(seed=0, n=60, m=24):
    db, labels, name = data(seed, n, m)
    return Dataset.from_dense(db, labels, name=name, device="cpu")


def session(n_miners=1, **kw):
    return MinerSession(n_miners, device="cpu",
                        runtime=RuntimeConfig(**dict(CKPT_CFG, **kw)))


def _assert_identical(a, b):
    assert (a.min_sup, a.correction_factor, a.delta, a.n_significant) == (
        b.min_sup, b.correction_factor, b.delta, b.n_significant)
    assert a.results.to_json() == b.results.to_json()


# ------------------------------------------------------------ kill + resume
def test_kill_and_resume_bit_identical(tmp_path):
    ds = small_dataset(seed=1)
    baseline = session().run(ds, Q)
    classic = MinerSession(1, device="cpu",
                           runtime=RuntimeConfig(expand_batch=4)).run(ds, Q)
    _assert_identical(baseline, classic)   # segmenting changes nothing
    with injected(FaultPlan(die_after_segments=2)):
        with pytest.raises(SimulatedFault):
            session().run(ds, Q, ckpt_dir=str(tmp_path))
    resumed = session().run(ds, Q, resume_from=str(tmp_path))
    assert any(p.resumed for p in resumed.phases)
    assert not resumed.partial and resumed.results.complete
    _assert_identical(baseline, resumed)


def test_completed_run_restores_every_phase(tmp_path):
    """The terminal carry of each phase is checkpointed too, so resuming a
    finished mine skips every loop and still gives the answer exactly."""
    ds = small_dataset(seed=2)
    first = session().run(ds, Q, ckpt_dir=str(tmp_path))
    again = session().run(ds, Q, resume_from=str(tmp_path))
    assert all(p.resumed for p in again.phases)
    _assert_identical(first, again)


def test_ckpt_flags_require_ckpt_period(tmp_path):
    ds = small_dataset(seed=1)
    plain = MinerSession(1, device="cpu", runtime=RuntimeConfig(expand_batch=4))
    for kw in (dict(ckpt_dir=str(tmp_path)), dict(resume_from=str(tmp_path))):
        with pytest.raises(ValueError, match="ckpt_period"):
            plain.run(ds, Q, **kw)
    # should_stop is ignored by the classic loop, as in the JAX session
    rep = plain.run(ds, Q, should_stop=lambda: True)
    assert not rep.partial and rep.results.complete
    # a stream needs no segments either: its head is the classic run's
    heads = []
    streamed = plain.run(ds, Q, stream=ResultStream(head_k=3, on_head=heads.append))
    assert heads == [rep.results.patterns[:3]]
    assert streamed.results.to_json() == rep.results.to_json()


def test_ckpt_writes_counted_in_phase_reports(tmp_path):
    ds = small_dataset(seed=1)
    s = session()
    report = s.run(ds, Q, ckpt_dir=str(tmp_path))
    jds = japi.Dataset.from_dense(*data(seed=1)[:2], name="ft1")
    want = japi.MinerSession(jax.devices()[:1], runtime=japi.RuntimeConfig(
        **CKPT_CFG)).run(jds, japi.SignificantPatternQuery(), ckpt_dir=str(tmp_path / "j"))
    assert [(p.ckpt_writes, p.ckpt_bytes) for p in report.phases] == [
        (p.ckpt_writes, p.ckpt_bytes) for p in want.phases]
    assert all(p.ckpt_writes > 0 and p.ckpt_path for p in report.phases)
    assert [os.path.relpath(p.ckpt_path, tmp_path) for p in report.phases] == [
        os.path.relpath(p.ckpt_path, tmp_path / "j") for p in want.phases]
    text = s.metrics.expose_text()
    assert validate_prometheus_text(text) > 0
    assert "miner_ckpt_write_seconds" in text
    assert (f"miner_ckpt_bytes_total {sum(p.ckpt_bytes for p in report.phases)}"
            in text)
    again = session()
    again.run(ds, Q, resume_from=str(tmp_path))
    assert (f"miner_ckpt_restore_seconds_count {len(report.phases)}"
            in again.metrics.expose_text())


# --------------------------------------------------------------- provenance
def test_provenance_mismatch_refused(tmp_path):
    ds = small_dataset(seed=1)
    session().run(ds, Q, ckpt_dir=str(tmp_path))
    other = small_dataset(seed=9)  # same shape bucket, different bytes
    with pytest.raises(ProvenanceMismatch, match="fingerprint"):
        session().run(other, Q, resume_from=str(tmp_path))


def test_corrupt_newest_step_falls_back(tmp_path):
    """Byte rot in the newest frontier step: resume warns, falls back to an
    older valid step, and the answer is still bit-identical."""
    ds = small_dataset(seed=3)
    baseline = session().run(ds, Q)
    kw = dict(expand_batch=1, steal_enabled=False, ckpt_period=1)
    with injected(FaultPlan(die_after_segments=6)):
        with pytest.raises(SimulatedFault):
            session(**kw).run(ds, Q, ckpt_dir=str(tmp_path))
    phase_dir = os.path.join(str(tmp_path), "00_lamp1")
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(phase_dir)
                   if d.startswith("step_"))
    assert len(steps) >= 2
    corrupt_step_dir(os.path.join(phase_dir, f"step_{steps[-1]}"))
    with pytest.warns(RuntimeWarning, match="corrupt"):
        resumed = session(**kw).run(ds, Q, resume_from=str(tmp_path))
    _assert_identical(baseline, resumed)


# --------------------------------------------------------- partial results
def _same(x, y) -> bool:
    return x == y or (isinstance(x, float) and isinstance(y, float)
                      and math.isnan(x) and math.isnan(y))


def _query(kind, api):
    return {"fused23": lambda: api.SignificantPatternQuery(pipeline="fused23"),
            "three_phase": lambda: api.SignificantPatternQuery(pipeline="three_phase"),
            "closed-frequent": lambda: api.ClosedFrequentQuery(min_sup=2),
            "topk": lambda: api.TopKSignificantQuery(k=5)}[kind]()


@pytest.mark.parametrize("kind, stop_after, stopped_mode", [
    ("three_phase", 2, "lamp1"),       # mid lambda search
    ("fused23", 80, "count2d"),        # in the fused pass
    ("closed-frequent", 6, "test"),
    ("topk", 40, "test"),              # mid-probe
])
def test_soft_stop_partial_report_equals_jax_then_resumes(kind, stop_after,
                                                          stopped_mode, tmp_path):
    """A should_stop that fires after `stop_after` polls gives the JAX
    package's partial report at the same stop point — truncated ResultSet,
    phase values, checkpoint step — and the port's checkpoint resumes to
    the uninterrupted answer."""
    db, labels, name = data(seed=4, n=80, m=32)
    ds = Dataset.from_dense(db, labels, name=name, device="cpu")
    jds = japi.Dataset.from_dense(db, labels, name=name)
    cfg = dict(expand_batch=1, steal_enabled=False, ckpt_period=1)

    def stopper():
        polls = {"n": 0}

        def stop():
            polls["n"] += 1
            return polls["n"] > stop_after
        return stop

    got = session(**cfg).run(ds, _query(kind, tapi),
                             ckpt_dir=str(tmp_path / "port"), should_stop=stopper())
    want = japi.MinerSession(jax.devices()[:1], runtime=japi.RuntimeConfig(**cfg)).run(
        jds, _query(kind, japi), ckpt_dir=str(tmp_path / "jax"), should_stop=stopper())
    assert got.partial and want.partial and got.phases[-1].mode == stopped_mode
    assert not got.results.complete and got.results.truncated
    for f in ("dataset", "pipeline", "alpha", "lambda_final", "min_sup",
              "correction_factor", "delta", "n_significant", "statistic", "query",
              "partial"):
        assert _same(getattr(got, f), getattr(want, f)), f
    assert os.path.relpath(got.ckpt_path, tmp_path / "port") == os.path.relpath(
        want.ckpt_path, tmp_path / "jax")
    assert [(p.mode, p.supersteps, p.partial) for p in got.phases] == [
        (p.mode, p.supersteps, p.partial) for p in want.phases]
    assert got.results.to_json() == want.results.to_json()
    full = session(**cfg).run(ds, _query(kind, tapi))
    done = session(**cfg).run(ds, _query(kind, tapi),
                              resume_from=str(tmp_path / "port"))
    assert done.results.complete and not done.partial
    assert done.results.to_json() == full.results.to_json()


# ------------------------------------------------------- elastic resharding
@pytest.mark.parametrize("new_miners", [8, 4, 1])
def test_elastic_resume_8_to_fewer(tmp_path, new_miners):
    ds = small_dataset(seed=5, n=100, m=32)
    baseline = session(8).run(ds, Q)
    with injected(FaultPlan(die_after_segments=2)):
        with pytest.raises(SimulatedFault):
            session(8).run(ds, Q, ckpt_dir=str(tmp_path))
    resumed = session(new_miners).run(ds, Q, resume_from=str(tmp_path))
    assert any(p.resumed for p in resumed.phases)
    _assert_identical(baseline, resumed)
    # the uninterrupted answer is the JAX package's (it does not depend on P)
    jds = japi.Dataset.from_dense(*data(seed=5, n=100, m=32)[:2], name="ft5")
    want = japi.MinerSession(jax.devices()[:1], runtime=japi.RuntimeConfig(
        **CKPT_CFG)).run(jds, japi.SignificantPatternQuery())
    assert resumed.results.to_json() == want.results.to_json()


def test_engine_mine_segmented_equals_classic(tmp_path):
    """`core.engine.mine` with ckpt_period: the same output as the classic
    loop, a stop that leaves a partial output, and a resume to the end."""
    from repro_torch.core.engine import EngineConfig, mine

    db, labels, _ = data(seed=6)
    kw = dict(expand_batch=2, stack_cap=512, steal_max=16, push_cap=16)
    classic = mine(db, labels, mode="count", min_sup=3, n_miners=3, device="cpu",
                   cfg=EngineConfig(**kw))
    cfg = EngineConfig(ckpt_period=3, **kw)
    seg = mine(db, labels, mode="count", min_sup=3, n_miners=3, device="cpu", cfg=cfg)
    assert (seg.hist.tolist(), seg.supersteps, seg.complete) == (
        classic.hist.tolist(), classic.supersteps, True)
    for name in classic.stats:
        assert seg.stats[name].tolist() == classic.stats[name].tolist(), name
    part = mine(db, labels, mode="count", min_sup=3, n_miners=3, device="cpu", cfg=cfg,
                ckpt_dir=str(tmp_path), should_stop=lambda: True)
    assert not part.complete and part.supersteps == 3
    rest = mine(db, labels, mode="count", min_sup=3, n_miners=3, device="cpu", cfg=cfg,
                resume_from=str(tmp_path))
    assert rest.hist.tolist() == classic.hist.tolist()
    with pytest.raises(ValueError, match="ckpt_period"):
        mine(db, labels, mode="count", min_sup=3, device="cpu",
             cfg=EngineConfig(**kw), ckpt_dir=str(tmp_path))


def test_fault_tolerant_example_smoke(capsys):
    from repro_torch.examples import fault_tolerant_mining

    fault_tolerant_mining.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "injected kill" in out and "OK:" in out


def test_closed_frequent_and_topk_segmented_equal_classic():
    ds = small_dataset(seed=7)
    for q in (ClosedFrequentQuery(min_sup=3), TopKSignificantQuery(k=4)):
        seg = session(2).run(ds, q)
        classic = MinerSession(2, device="cpu", runtime=RuntimeConfig(
            expand_batch=4)).run(ds, q)
        assert seg.results.to_json() == classic.results.to_json()
        assert [p.supersteps for p in seg.phases] == [p.supersteps for p in classic.phases]


def test_warmup_builds_segmented_programs():
    """warmup() builds the segment programs a ckpt_period session runs, so
    its first query builds nothing."""
    ds = small_dataset(seed=1)
    s = session()
    assert s.warmup(ds, pipeline="fused23") == 2
    assert s.has_programs(ds.bucket, pipeline="fused23")
    rep = s.run(ds, SignificantPatternQuery(pipeline="fused23"))
    assert not rep.cold and rep.results.complete
