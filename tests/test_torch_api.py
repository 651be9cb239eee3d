"""The port's session API (repro_torch.api) held against the JAX package's
(repro.api), both on the CPU.

Both packages get the same numpy inputs.  Everything integer is compared
exactly — buckets, packed arrays, stack sizing, every MineReport field,
every phase's raw output — and the ResultSets by their TSV/JSON exports,
which carry each float64 P- and q-value exactly.  One stated tolerance: a
record is emitted when its float32 device P-value clears the gate, and
torch's `lgamma`/`log_ndtr` differ from JAX's in the last bits, so a
record whose float64 P-value lies within `gate_rtol(N)` (relative) of the
gate may be emitted by one package and not the other.  Such records are
reported as warnings, and only they may differ.

P = 1 runs in-process; P = 8 runs the JAX side in a subprocess with eight
simulated devices (tests/engine_subproc_main.py, unchanged).
"""

import dataclasses
import json
import math
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
from repro.core.lcm import lcm_closed  # noqa: E402
from repro.data.synthetic import SyntheticSpec, generate  # noqa: E402
from repro_torch.core.bitmap import pack_db  # noqa: E402
from repro_torch.core.engine import EngineConfig  # noqa: E402
from repro_torch.stats import gate_rtol, get_statistic  # noqa: E402
from repro_torch.topo import Topology  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    torch's default of one thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_problem(seed, n_items=60, n_transactions=48, n_pos=16):
    spec = SyntheticSpec("t", n_items, n_transactions, 0.15, n_pos, 2, seed=seed)
    db, labels, _ = generate(spec)
    return db, labels


def datasets(db, labels, **kw):
    """(JAX Dataset, port Dataset on the CPU) of the same inputs."""
    return (japi.Dataset.from_dense(db, labels, **kw),
            tapi.Dataset.from_dense(db, labels, device="cpu", **kw))


def sessions(**runtime):
    """(JAX session on one CPU device, port session on the CPU), P = 1."""
    return (japi.MinerSession(devices=jax.devices()[:1],
                              runtime=japi.RuntimeConfig(**runtime)),
            tapi.MinerSession(1, device="cpu", runtime=tapi.RuntimeConfig(**runtime)))


@pytest.fixture(scope="module")
def shared_sessions():
    return sessions()


def _same(x, y) -> bool:
    return x == y or (isinstance(x, float) and isinstance(y, float)
                      and math.isnan(x) and math.isnan(y))


def _near_gate(sup, pos, gate, statistic, n, n_pos) -> np.ndarray:
    p = get_statistic(statistic).pvalue(sup, pos, n, n_pos)
    return np.abs(p - gate) <= gate_rtol(n) * gate


def assert_outputs_match(a, b, *, gate, statistic, n, n_pos) -> int:
    """A JAX MineOutput against the port's: equal field by field, except
    emitted records near the emission gate.  Returns how many such records
    either side emitted (each reported as a warning)."""
    np.testing.assert_array_equal(a.hist, b.hist)
    assert (a.lam_final, a.supersteps, a.emit_dropped, a.complete) == (
        b.lam_final, b.supersteps, b.emit_dropped, b.complete)
    assert set(a.stats) == set(b.stats)
    for name in a.stats:
        np.testing.assert_array_equal(a.stats[name], b.stats[name], err_msg=name)
    np.testing.assert_array_equal(a.db_bits, b.db_bits)
    for f in ("hist2d",):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)
    if a.sig_occ is None:
        assert b.sig_occ is None and a.sig_count == b.sig_count
        return 0
    near_a = np.zeros(len(a.sig_sup), bool)
    near_b = np.zeros(len(b.sig_sup), bool)
    if statistic is not None:
        near_a = _near_gate(a.sig_sup, a.sig_pos_sup, gate, statistic, n, n_pos)
        near_b = _near_gate(b.sig_sup, b.sig_pos_sup, gate, statistic, n, n_pos)
    for f in ("sig_occ", "sig_core", "sig_sup", "sig_pos_sup"):
        np.testing.assert_array_equal(getattr(a, f)[~near_a], getattr(b, f)[~near_b],
                                      err_msg=f)
    n_near = int(near_a.sum() + near_b.sum())
    if n_near:
        warnings.warn(f"{n_near} emitted records within {gate_rtol(n):.2e} of the gate "
                      f"{gate!r}: JAX {near_a.sum()}, port {near_b.sum()}")
    assert a.sig_count - b.sig_count == int(near_a.sum()) - int(near_b.sum())
    return n_near


#: PhaseReport fields compared exactly (walls and build times differ)
PHASE_FIELDS = tuple(f.name for f in dataclasses.fields(tapi.PhaseReport)
                     if f.name not in ("wall_s", "compile_s", "output"))
REPORT_FIELDS = ("dataset", "pipeline", "alpha", "lambda_final", "min_sup",
                 "correction_factor", "delta", "n_significant", "statistic",
                 "query", "partial", "ckpt_path")


def assert_reports_match(want, got, *, n, n_pos):
    """Every field of a JAX MineReport against the port's, every phase and
    its raw output, and the ResultSet exports — with the stated tolerance
    at the float32 emission gates."""
    assert len(want.phases) == len(got.phases)
    n_near = 0
    for pa, pb in zip(want.phases, got.phases):
        for f in PHASE_FIELDS:
            assert _same(getattr(pa, f), getattr(pb, f)), (pa.mode, f)
        gate = want.delta if pa.mode == "test" else want.alpha
        n_near += assert_outputs_match(pa.output, pb.output, gate=gate,
                                       statistic=want.statistic, n=n, n_pos=n_pos)
    fields = REPORT_FIELDS if not n_near else tuple(
        f for f in REPORT_FIELDS if f != "n_significant")
    for f in fields:
        assert _same(getattr(want, f), getattr(got, f)), f
    rj, rt = want.results, got.results
    for f in ("n_transactions", "n_pos", "min_sup", "correction_factor",
              "n_dropped", "item_names", "statistic", "truncated", "complete"):
        assert getattr(rj, f) == getattr(rt, f), f
    if not n_near:
        assert rt.to_tsv() == rj.to_tsv()
        assert rt.to_json() == rj.to_json()


# ------------------------------------------------------------ dataset, config
@pytest.mark.parametrize("dims", [
    (1, 1, 1), (48, 16, 60), (64, 16, 64), (65, 17, 65), (697, 105, 1191),
    (697, 105, 11914), (364, 176, 250120), (12773, 1129, 397)])
@pytest.mark.parametrize("policy", [
    {}, dict(exact=True), dict(growth=1.5, min_items=32), dict(item_tile=512)])
def test_bucket_rounding_matches_jax(dims, policy):
    want = japi.BucketPolicy(**policy).bucket_for(*dims)
    got = tapi.BucketPolicy(**policy).bucket_for(*dims)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.tile, got.n_tiles, got.words) == (want.tile, want.n_tiles, want.words)


def _packed_equal(jp, tp):
    np.testing.assert_array_equal(tp.layout.tiles, jp.layout.tiles)
    np.testing.assert_array_equal(tp.pos_mask, jp.pos_mask)
    np.testing.assert_array_equal(tp.occ0, jp.occ0)
    for f in ("n", "n_pos", "m", "n_pad", "npos_pad", "m_pad", "has_labels"):
        assert getattr(tp, f) == getattr(jp, f), f
    # the device copy holds the same bits
    np.testing.assert_array_equal(
        tp.db_dev.numpy().view(np.uint32), jp.layout.tiles)


@pytest.mark.parametrize("kind", ["dense", "unlabelled", "packed_words",
                                  "transactions", "tsv", "placeholder", "tiled"])
def test_dataset_packing_matches_jax(kind, tmp_path):
    db, labels = small_problem(3, n_items=70, n_transactions=50)
    if kind == "dense":
        j, t = datasets(db, labels, item_names=[f"i{k}" for k in range(70)])
    elif kind == "unlabelled":
        j, t = datasets(db, None)
    elif kind == "tiled":
        policy = dict(bucket_policy=japi.BucketPolicy(item_tile=32))
        j = japi.Dataset.from_dense(db, labels, **policy)
        t = tapi.Dataset.from_dense(db, labels, device="cpu", bucket_policy=(
            tapi.BucketPolicy(item_tile=32)))
    elif kind == "packed_words":
        bits = pack_db(db)
        j = japi.Dataset.from_packed_words(bits, labels, n_transactions=50)
        t = tapi.Dataset.from_packed_words(bits, labels, n_transactions=50,
                                           device="cpu")
    elif kind == "transactions":
        txns = [[f"tok{k}" for k in np.flatnonzero(row)] for row in db]
        j = japi.Dataset.from_transactions(txns, labels)
        t = tapi.Dataset.from_transactions(txns, labels, device="cpu")
    elif kind == "tsv":
        path = tmp_path / "d.tsv"
        path.write_text("# comment\n" + "".join(
            f"{int(lab)}\t" + "\t".join(f"s{k}" for k in np.flatnonzero(row)) + "\n"
            for row, lab in zip(db, labels)))
        j = japi.Dataset.from_tsv(str(path))
        t = tapi.Dataset.from_tsv(str(path), device="cpu")
    else:
        bucket = japi.BucketPolicy().bucket_for(50, 20, 70)
        j = japi.Dataset.placeholder(bucket)
        t = tapi.Dataset.placeholder(tapi.ShapeBucket(**dataclasses.asdict(bucket)),
                                     device="cpu")
    assert dataclasses.asdict(t.bucket) == dataclasses.asdict(j.bucket)
    assert (t.name, t.item_names, t.n_transactions, t.n_items, t.n_pos) == (
        j.name, j.item_names, j.n_transactions, j.n_items, j.n_pos)
    assert (t.labels is None) == (j.labels is None)
    if j.labels is not None:
        np.testing.assert_array_equal(t.labels, j.labels)
        assert not t.labels.flags.writeable
    _packed_equal(j.packed, t.packed)
    assert t.packed.device == torch.device("cpu")


def test_dataset_from_paper_problem_matches_jax():
    j = japi.Dataset.from_paper_problem("hapmap_dom_10", 0.005)
    t = tapi.Dataset.from_paper_problem("hapmap_dom_10", 0.005, device="cpu")
    assert dataclasses.asdict(t.spec) == dataclasses.asdict(j.spec)
    assert (t.item_names, t.planted) == (j.item_names, j.planted)
    _packed_equal(j.packed, t.packed)


@pytest.mark.parametrize("n_miners", [1, 8, 12])
@pytest.mark.parametrize("bucket", [(64, 16, 64, 0), (1024, 128, 2048, 0),
                                    (1024, 128, 16384, 4096),
                                    (512, 256, 262144, 4096), (16384, 2048, 512, 0)])
@pytest.mark.parametrize("runtime", [{}, dict(stack_mem_mb=1),
                                     dict(stack_cap=777), dict(push_cap=4096)])
def test_resolve_stack_cap_matches_jax(bucket, n_miners, runtime):
    want = japi.RuntimeConfig(**runtime).resolve(japi.ShapeBucket(*bucket), n_miners)
    got = tapi.RuntimeConfig(**runtime).resolve(tapi.ShapeBucket(*bucket), n_miners,
                                                "cpu")
    assert got.stack_cap == want.stack_cap
    for f in ("expand_batch", "steal_max", "push_cap", "out_cap", "max_steps",
              "n_random_perms", "seed", "steal_enabled", "kernel_impl",
              "kernel_blocks", "sync_period", "ckpt_period", "topology"):
        assert getattr(got, f) == getattr(want, f), f


# ------------------------------------------------------------------ queries
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("statistic", ["fisher", "chi2"])
@pytest.mark.parametrize("pipeline", ["three_phase", "fused23"])
def test_run_matches_jax_p1(pipeline, statistic, seed, shared_sessions):
    db, labels = small_problem(seed)
    jd, td = datasets(db, labels)
    js, ts = shared_sessions
    query = dict(pipeline=pipeline, statistic=statistic)
    want = js.run(jd, japi.SignificantPatternQuery(**query))
    got = ts.run(td, tapi.SignificantPatternQuery(**query))
    assert_reports_match(want, got, n=jd.n_transactions, n_pos=jd.n_pos)
    assert got.n_significant > 0 and len(got.results) == got.n_significant
    assert got.kernel_impl == "ref"
    assert got.to_legacy_dict().keys() == want.to_legacy_dict().keys()


@pytest.mark.parametrize("top_k", [None, 7])
@pytest.mark.parametrize("labelled", [True, False])
@pytest.mark.parametrize("min_sup", [3, 6])
def test_closed_frequent_matches_jax_and_lcm(min_sup, labelled, top_k,
                                             shared_sessions):
    db, labels = small_problem(4)
    jd, td = datasets(db, labels if labelled else None)
    js, ts = shared_sessions
    want = js.run(jd, japi.ClosedFrequentQuery(min_sup=min_sup, top_k=top_k))
    got = ts.run(td, tapi.ClosedFrequentQuery(min_sup=min_sup, top_k=top_k))
    assert_reports_match(want, got, n=jd.n_transactions, n_pos=jd.n_pos)
    oracle, _ = lcm_closed(db, min_sup=min_sup)
    assert got.n_significant == len(oracle)
    if top_k is None:
        assert {(frozenset(p.items), p.support) for p in got.results} == set(oracle)
    assert got.summary().startswith("dense[closed-frequent]")


@pytest.mark.parametrize("k", [1, 5, 12])
@pytest.mark.parametrize("statistic", ["fisher", "chi2"])
def test_topk_matches_jax(statistic, k, shared_sessions):
    """The bisection probes the same deltas with the same counts until a
    probe's gate falls within gate_rtol(N) of an emitted record; there the
    float32 tests may count differently (reported), after which the probes
    part.  The returned patterns must agree exactly."""
    db, labels = small_problem(5)
    jd, td = datasets(db, labels)
    js, ts = shared_sessions
    want = js.run(jd, japi.TopKSignificantQuery(k=k, statistic=statistic))
    got = ts.run(td, tapi.TopKSignificantQuery(k=k, statistic=statistic))
    n, n_pos = jd.n_transactions, jd.n_pos

    def probes(rep):
        return [(p.output.sig_count, p.supersteps) for p in rep.phases]

    if probes(want) == probes(got) and want.delta == got.delta:
        assert_reports_match(want, got, n=n, n_pos=n_pos)
    else:
        # the probes parted: some probe's gate sat on an emitted record
        near = [p for rep in (want, got) for p in rep.phases for gate in
                (want.delta, got.delta) if len(p.output.sig_sup) and _near_gate(
                    p.output.sig_sup, p.output.sig_pos_sup, gate, statistic,
                    n, n_pos).any()]
        assert near, "the probes parted with no record near a gate"
        assert abs(got.delta - want.delta) <= gate_rtol(n) * want.delta
        warnings.warn(f"top-k probes parted at the float32 gate: JAX delta "
                      f"{want.delta!r}, port {got.delta!r}")
    keys = [(p.items, p.support, p.pos_support, p.pvalue) for p in got.results]
    assert keys == [(p.items, p.support, p.pos_support, p.pvalue)
                    for p in want.results]
    assert len(keys) == got.n_significant <= k


def test_warm_query_builds_nothing_and_repeats_bit_identically():
    db, labels = small_problem(0)
    db2, labels2 = small_problem(7)   # another dataset of the same bucket
    js, ts = sessions()
    _, td = datasets(db, labels)
    _, td2 = datasets(db2, labels2)
    assert td.bucket == td2.bucket
    for pipeline, new in (("three_phase", 3), ("fused23", 1)):   # lamp1 shared
        q = tapi.SignificantPatternQuery(pipeline=pipeline)
        before = ts.cache_info().misses
        cold = ts.run(td, q)
        misses = ts.cache_info().misses
        assert cold.cold and misses - before == new
        warm = ts.run(td, q)
        other = ts.run(td2, tapi.SignificantPatternQuery(pipeline=pipeline, alpha=0.1))
        assert ts.cache_info().misses == misses
        assert not warm.cold and not other.cold
        assert [p.compile_s for p in warm.phases] == [0.0] * len(warm.phases)
        assert warm.results.to_json() == cold.results.to_json()
        assert ts.has_programs(td.bucket, pipeline=pipeline)
    assert not ts.has_programs(td.bucket, "chi2")
    assert ts.warmup(td.bucket, statistic="chi2", pipeline="fused23") == 1
    assert ts.warmup(td, statistic="chi2", pipeline="fused23") == 0
    assert ts.has_programs(td.bucket, "chi2", pipeline="fused23")
    expo = ts.metrics.expose_text()
    for name in ("miner_cache_hits_total", "miner_cache_misses_total",
                 "miner_phase_seconds", "miner_query_seconds"):
        assert name in expo
    spans = {e["name"] for e in ts.tracer.events()}
    assert {"query:SignificantPatternQuery", "phase:lamp1", "compile", "dispatch",
            "reconstruct", "warmup"} <= spans


def _lru_sequence(session, ds):
    """The JAX test's LRU walk (tests/test_api.py), as cache snapshots."""
    snaps = []

    def snap():
        ci = session.cache_info()
        snaps.append((ci.hits, ci.misses, ci.evictions,
                      sorted((p.mode, p.calls) for p in ci.programs)))

    session.run_phase(ds, "lamp1")
    session.run_phase(ds, "count", min_sup=5)
    snap()
    session.run_phase(ds, "test", min_sup=5, delta=1e-4)
    snap()
    session.run_phase(ds, "count", min_sup=5)
    session.run_phase(ds, "lamp1")
    snap()
    session.run_phase(ds, "test", min_sup=5, delta=1e-4)
    snap()
    snaps.append(session.clear_cache())
    snap()
    assert "evicted" in str(session.cache_info())
    return snaps


def test_lru_eviction_and_clear_cache_match_jax():
    db, labels = small_problem(1)
    jd, td = datasets(db, labels)
    js, ts = sessions(max_programs=2)
    assert _lru_sequence(ts, td) == _lru_sequence(js, jd)


def _err(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e).__name__, str(e).replace("repro_torch", "repro")
    return None


def _on_cpu(api) -> dict:
    """The port's entry points take device="cpu" here; JAX's take none."""
    return {"device": "cpu"} if api is tapi else {}


#: (description, call on a package's api module with (session, dataset,
#: unlabelled dataset)) — each must raise the same error in both packages
BAD_CALLS = {
    "alpha>1": lambda api, s, d, u: api.SignificantPatternQuery(alpha=1.5),
    "alpha=0": lambda api, s, d, u: api.SignificantPatternQuery(alpha=0.0),
    "alpha int": lambda api, s, d, u: api.SignificantPatternQuery(alpha=1),
    "statistic": lambda api, s, d, u: api.SignificantPatternQuery(statistic="nope"),
    "min_sup": lambda api, s, d, u: api.ClosedFrequentQuery(min_sup=0),
    "top_k": lambda api, s, d, u: api.ClosedFrequentQuery(min_sup=5, top_k=0),
    "k": lambda api, s, d, u: api.TopKSignificantQuery(k=0),
    "max_probes": lambda api, s, d, u: api.TopKSignificantQuery(k=2, max_probes=0),
    "topk statistic": lambda api, s, d, u: api.TopKSignificantQuery(k=3,
                                                                    statistic="x"),
    "mode": lambda api, s, d, u: s.run_phase(d, "count3d"),
    "phase statistic": lambda api, s, d, u: s.run_phase(d, "test", statistic="x"),
    "not a query": lambda api, s, d, u: s.run(d, "significant"),
    "pipeline": lambda api, s, d, u: s.run(d, api.SignificantPatternQuery(
        pipeline="nope")),
    "unlabelled": lambda api, s, d, u: s.run(u, api.SignificantPatternQuery()),
    "unlabelled topk": lambda api, s, d, u: s.run(u, api.TopKSignificantQuery(k=3)),
    "mine None": lambda api, s, d, u: s.mine(d, statistic=None),
    "has_programs pipeline": lambda api, s, d, u: s.has_programs(d.bucket,
                                                                 pipeline="x"),
    "warmup statistic": lambda api, s, d, u: s.warmup(d.bucket, statistic="x"),
    "placeholder": lambda api, s, d, u: api.Dataset.placeholder("bucket"),
    "labels shape": lambda api, s, d, u: api.Dataset.from_dense(
        np.zeros((4, 3), bool), np.zeros(5, bool), **_on_cpu(api)),
    "names": lambda api, s, d, u: api.Dataset.from_dense(
        np.zeros((4, 3), bool), item_names=["a"], **_on_cpu(api)),
    "max_programs": lambda api, s, d, u: api.MinerSession(
        runtime=api.RuntimeConfig(max_programs=0), **_on_cpu(api)),
}


@pytest.mark.parametrize("name", sorted(BAD_CALLS))
def test_validation_errors_match_jax(name, shared_sessions):
    db, labels = small_problem(2)
    jd, td = datasets(db, labels)
    ju, tu = datasets(db, None)
    js, ts = shared_sessions
    want = _err(lambda: BAD_CALLS[name](japi, js, jd, ju))
    got = _err(lambda: BAD_CALLS[name](tapi, ts, td, tu))
    assert want is not None
    assert got == want


@pytest.mark.parametrize("case", [
    "trace_period", "ckpt_period", "topology", "kernel_blocks", "stream",
    "ckpt_dir", "resume_from", "device_mismatch"])
def test_unported_options_raise(case):
    """The trace ring, the segmented program, streaming, topologies and the
    kernel's tile are ported (items 7-10 and the autotuner: the session
    runs them; a topology of another miner count is refused with the JAX
    package's error, a tile that is not a candidate of the superstep's
    launch with the candidates), and ckpt_dir/resume_from without
    ckpt_period are refused as the JAX session refuses them."""
    db, labels = small_problem(0)
    _, td = datasets(db, labels)
    q = tapi.SignificantPatternQuery()
    runtime = dict(trace_period=dict(trace_period=1),
                   ckpt_period=dict(ckpt_period=4),
                   topology=dict(topology=Topology(1, 1)),
                   kernel_blocks=dict(kernel_blocks=(16, 32, 32))).get(case)
    if case in ("trace_period", "ckpt_period", "topology", "kernel_blocks"):
        rep = tapi.MinerSession(device="cpu", runtime=tapi.RuntimeConfig(**runtime)).run(
            td, q)
        assert all((p.trace is not None) == (case == "trace_period") for p in rep.phases)
        assert rep.results.complete and not rep.partial
        if case == "topology":
            flat = tapi.MinerSession(device="cpu").run(td, q)
            assert rep.results.to_json() == flat.results.to_json()
            with pytest.raises(ValueError, match="topology 2x4 needs 8 devices, got 1"):
                tapi.MinerSession(device="cpu", runtime=tapi.RuntimeConfig(
                    topology=Topology(2, 4)))
        if case == "kernel_blocks":
            # the plain version ignores the tile; the resolved config keeps
            # it, as the JAX package's does
            assert all(p.kernel_blocks == (16, 32, 32) for p in rep.phases)
            flat = tapi.MinerSession(device="cpu").run(td, q)
            assert rep.results.to_json() == flat.results.to_json()
            assert all(p.kernel_blocks is None for p in flat.phases)
            bad = tapi.MinerSession(device="cpu", runtime=tapi.RuntimeConfig(
                kernel_blocks=(8, 512, 32)))
            with pytest.raises(ValueError, match=r"kernel_blocks \(8, 512, 32\).*"
                               r"valid.*\(16, 64, 32\)"):
                bad.run(td, q)
            with pytest.raises(ValueError, match="kernel_blocks"):
                tapi.RuntimeConfig(kernel_blocks=(8, 512, 32)).resolve(td.bucket, 1, "cpu")
        return
    session = tapi.MinerSession(device="cpu")
    if case == "device_mismatch":
        td.packed = dataclasses.replace(td.packed, device=torch.device("cuda", 0))
        with pytest.raises(ValueError, match="lies on cuda:0"):
            session.run(td, q)
        return
    if case == "stream":
        from repro_torch.results import ResultStream

        heads = []
        rep = session.run(td, q, stream=ResultStream(head_k=2, on_head=heads.append))
        assert len(heads) == 1 and heads[0] == rep.results.patterns[:2]
        assert rep.results.to_json() == session.run(td, q).results.to_json()
        return
    with pytest.raises(ValueError, match="need the segmented program"):
        session.run(td, q, **{case: "dir"})


@pytest.mark.parametrize("what", ["session", "dataset", "placeholder", "paper"])
def test_entry_points_need_cuda(what):
    """Without a card, the default device refuses instead of using the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    db, labels = small_problem(0)
    calls = {
        "session": lambda: tapi.MinerSession(8),
        "dataset": lambda: tapi.Dataset(db, labels),
        "placeholder": lambda: tapi.Dataset.placeholder(tapi.ShapeBucket(64, 16, 64)),
        "paper": lambda: tapi.Dataset.from_paper_problem("hapmap_dom_10", 0.005),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[what]()


# ------------------------------------------------------------------ P = 8
def run_subproc(spec: dict) -> dict:
    from repro.core.collectives import host_device_count_env

    env = host_device_count_env(spec["n_devices"])
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "engine_subproc_main.py"), json.dumps(spec)],
        capture_output=True, text=True, env=env, timeout=900,
    )
    assert out.returncode == 0, f"stderr:\n{out.stderr[-4000:]}"
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.slow
@pytest.mark.parametrize("pipeline", ["three_phase", "fused23"])
def test_session_p8_matches_jax_subprocess(pipeline):
    """Two same-bucket queries on one 8-miner session: the JAX session on
    eight simulated devices (engine_subproc_main mode "session") and the
    port's give the same values and patterns, and the same misses per query
    (the second query builds nothing)."""
    prob = dict(n_items=24, n_transactions=60, density=0.15, n_pos=20, seed=1,
                seed2=5)
    got = run_subproc(dict(prob, mode="session", n_devices=8, pipeline=pipeline))
    # engine_subproc_main.py's EngineConfig, with the stack sized by resolve()
    cfg = EngineConfig(expand_batch=8, stack_cap=4096, steal_max=64, push_cap=256,
                       out_cap=1024)
    session = tapi.MinerSession(
        8, device="cpu",
        algorithm=tapi.AlgorithmConfig(alpha=0.05, pipeline=pipeline),
        runtime=tapi.RuntimeConfig.from_engine_config(cfg).with_options(
            stack_cap=None),
    )
    misses = []
    for q, seed in zip(got["queries"], (1, 5)):
        db, labels, _ = generate(SyntheticSpec(
            name="sub", n_items=prob["n_items"], n_transactions=prob["n_transactions"],
            density=prob["density"], n_pos=prob["n_pos"], n_planted=2, seed=seed))
        rep = session.mine(tapi.Dataset.from_dense(db, labels, name=f"q{seed}",
                                                   device="cpu"))
        assert {k: q[k] for k in ("min_sup", "correction_factor", "delta",
                                  "n_significant", "cold")} == {
            "min_sup": rep.min_sup, "correction_factor": rep.correction_factor,
            "delta": rep.delta, "n_significant": rep.n_significant, "cold": rep.cold}
        assert q["patterns"] == [[list(p.items), p.support, p.pos_support, p.pvalue,
                                  p.qvalue] for p in rep.results]
        misses.append(session.cache_info().misses)
    assert misses == got["misses_per_query"]
    ci = session.cache_info()
    assert (ci.hits, ci.n_programs) == (got["hits"], got["n_programs"])
    assert sum(rep.phases[1].output.stats["steals_got"]) > 0, "P = 8 must steal"
