"""The port's slice end to end, on the CPU at P = 1.

The `fused23` query on hapmap_dom_20 at 1,191 items through
`repro_torch.api` against the JAX package's `MinerSession.run`; the JAX
package's values for every query `chip_smoke.py` runs on the card
(`QUERY_EXPECT`, `FULL_WIDTH`, and phase 6's `TRACE_EXPECT` and
`FRONTIER_EXPECT`, those on eight simulated JAX devices in subprocesses),
derived here — the one place that runs the 1,191-item JAX queries and the
full-width frontiers; how far the float32 emission gates of those
queries sit from the nearest counted cell; and the port's import hygiene
and its refusal to fall back to the CPU.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.api as japi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro.data.synthetic import paper_problem_packed as jax_paper_problem_packed  # noqa: E402
from repro_torch.data.synthetic import paper_problem_packed  # noqa: E402
from repro_torch.stats import get_statistic  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    FRONTIER_EXPECT,
    FULL_WIDTH,
    QUERY_EXPECT,
    TOPK,
    TRACE_EXPECT,
    _library,
    query_values,
)
from test_torch_jax_worker import collect, spawn_jax  # noqa: E402

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


@pytest.fixture(scope="module")
def jax_1191():
    """The JAX package's session and Dataset at 1,191 items, and a cache
    of its reports by QUERY_EXPECT tag."""
    bits, labels, _, spec = jax_paper_problem_packed("hapmap_dom_20", scale_items=0.1)
    ds = japi.Dataset.from_packed_words(bits, labels, n_transactions=spec.n_transactions,
                                        name=spec.name)
    session = japi.MinerSession(devices=jax.devices()[:1])
    reports = {}

    def report(tag):
        if tag not in reports:
            (pipeline, statistic), _ = QUERY_EXPECT[tag]
            query = (japi.TopKSignificantQuery(k=TOPK, statistic=statistic)
                     if pipeline == "topk" else japi.SignificantPatternQuery(
                         pipeline=pipeline, statistic=statistic))
            reports[tag] = session.run(ds, query)
        return reports[tag]

    return ds, report


def test_fused23_query_matches_jax_session(jax_1191):
    jds, report = jax_1191
    bits, labels, _, spec = paper_problem_packed("hapmap_dom_20", scale_items=0.1)
    jbits, jlabels, _, _ = jax_paper_problem_packed("hapmap_dom_20", scale_items=0.1)
    np.testing.assert_array_equal(bits, jbits)   # same seed, same arrays
    np.testing.assert_array_equal(labels, jlabels)
    want = report("a")
    # the port at the exact shape: the shape buckets' padding is covered by
    # tests/test_torch_api.py, and the CPU plain version at (1024, 128,
    # 2048) would take 4x as long here
    ds = tapi.Dataset.from_packed_words(bits, labels, n_transactions=spec.n_transactions,
                                        name=spec.name, device="cpu",
                                        bucket_policy=tapi.EXACT_BUCKETS)
    got = tapi.MinerSession(1, device="cpu").run(
        ds, tapi.SignificantPatternQuery(pipeline="fused23", statistic="fisher"))

    for f in ("dataset", "pipeline", "alpha", "lambda_final", "min_sup",
              "correction_factor", "delta", "n_significant", "statistic", "query"):
        assert getattr(got, f) == getattr(want, f), f
    assert len(got.phases) == len(want.phases) == 2
    for jph, ph in zip(want.phases, got.phases):
        for f in ("mode", "supersteps", "lam_final", "n_nodes", "steals",
                  "steal_rounds", "emit_dropped", "kernel_impl"):
            assert getattr(ph, f) == getattr(jph, f), f
        a, b = jph.output, ph.output
        np.testing.assert_array_equal(a.hist, b.hist)
        for name in a.stats:
            np.testing.assert_array_equal(a.stats[name], b.stats[name], err_msg=name)
    a, b = want.phases[1].output, got.phases[1].output
    np.testing.assert_array_equal(a.hist2d, b.hist2d)
    w = b.sig_occ.shape[1]   # the JAX session pads words to its shape bucket
    np.testing.assert_array_equal(a.sig_occ[:, :w], b.sig_occ)
    assert not a.sig_occ[:, w:].any()
    for f in ("sig_core", "sig_sup", "sig_pos_sup"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)

    rj, rt = want.results, got.results
    for f in ("n_transactions", "n_pos", "alpha", "min_sup", "correction_factor",
              "delta", "n_dropped", "item_names", "statistic", "truncated"):
        assert getattr(rt, f) == getattr(rj, f), f
    assert len(rt.patterns) == len(rj.patterns)
    for p, q in zip(rt.patterns, rj.patterns):
        assert (p.items, p.support, p.pos_support, p.pvalue, p.qvalue) == (
            q.items, q.support, q.pos_support, q.pvalue, q.qvalue)
    assert rt.to_tsv() == rj.to_tsv()
    assert rt.to_json() == rj.to_json()
    assert query_values(got) == query_values(want)


@pytest.mark.parametrize("tag", sorted(QUERY_EXPECT))
def test_chip_smoke_query_constants_are_jax_values(tag, jax_1191):
    """QUERY_EXPECT, which chip_smoke.py holds the card's runs to, is what
    the JAX package computes (its values do not depend on P)."""
    _, report = jax_1191
    got = query_values(report(tag))
    _, expect = QUERY_EXPECT[tag]
    assert {k: got[k] for k in expect} == expect


@pytest.mark.parametrize("name, min_sup, closed, sha", FULL_WIDTH)
def test_chip_smoke_full_width_constants_are_jax_values(name, min_sup, closed, sha):
    bits, labels, _, spec = jax_paper_problem_packed(name)
    ds = japi.Dataset.from_packed_words(bits, labels, n_transactions=spec.n_transactions,
                                        name=name)
    rep = japi.MinerSession(devices=jax.devices()[:1]).run(
        ds, japi.ClosedFrequentQuery(min_sup=min_sup))
    got = query_values(rep)
    assert (got["n_significant"], got["patterns"], got["results_sha256"]) == (
        closed, closed, sha)
    assert int(rep.phases[0].output.hist.sum()) == closed


def test_chip_smoke_trace_constants_are_jax_values():
    """Phase 6a's TRACE_EXPECT: query (a) on eight JAX devices, traced every
    superstep — the digest of its decoded traces, and each phase's
    trace_dropped with a ring of wrap_cap slots."""
    data = {"paper": "hapmap_dom_20", "scale_items": 0.1}
    (pipeline, statistic), expect = QUERY_EXPECT["a"]
    query = dict(pipeline=pipeline, statistic=statistic)
    procs = [spawn_jax(dict(dataset=data, query=query,
                            runtime=dict(trace_period=1, trace_cap=cap)), 8)
             for cap in (256, TRACE_EXPECT["wrap_cap"])]
    traced, wrapped = (collect(p) for p in procs)
    assert traced["n_devices"] == 8
    assert [p["supersteps"] for p in traced["phases"]] == [125, 104]
    assert [p["trace_dropped"] for p in traced["phases"]] == [0, 0]
    assert traced["trace_digest"] == TRACE_EXPECT["digest"]
    assert [p["trace_dropped"] for p in wrapped["phases"]] == TRACE_EXPECT["wrap_dropped"]
    for out in (traced, wrapped):
        assert (hashlib.sha256(out["results_json"].encode()).hexdigest()[:16]
                == expect["results_sha256"])


def test_chip_smoke_frontier_constants_are_jax_values(tmp_path):
    """Phase 6d's FRONTIER_EXPECT: the full-width hapmap_dom_20 Fisher query
    on eight JAX devices in segments of k supersteps, stopped after two —
    the frontier digests of its lamp1 phase at steps k and 2k."""
    k = FRONTIER_EXPECT["k"]
    out = collect(spawn_jax(dict(
        dataset={"paper": FRONTIER_EXPECT["problem"]}, runtime=dict(ckpt_period=k),
        query=dict(statistic="fisher"), ckpt_dir=str(tmp_path), stop_after=1), 8))
    assert out["partial"] and out["ckpt_path"].endswith(f"00_lamp1/step_{2 * k}")
    assert out["frontier_digest"] == FRONTIER_EXPECT["steps"]


@pytest.mark.parametrize("statistic, gates", [
    ("fisher", ("a", "b", "d")), ("chi2", ("c",))])
def test_float32_gate_distances_at_1191_items(statistic, gates, jax_1191):
    """How far each float32 emission gate of phase 4's queries sits from the
    nearest counted (support, pos-support) cell, relative to the gate: the
    count2d gate at alpha, the test gate at delta = alpha / k, and the top-k
    bracket's final delta.  The cells are those the fused23 query's 2-D
    histogram counted (support >= min_sup, which every gate's traversal
    covers).  A float32 P-value differs from float64 by at most
    4 eps32 log Gamma(N + 1) in log space (tests/test_torch_oracles.py), so a
    gate farther than that from every cell decides every record alike in
    JAX, the port on the CPU and the port on the card."""
    jds, report = jax_1191
    fused = report(gates[0])
    n, n_pos = jds.n_transactions, jds.n_pos
    h2 = fused.phases[1].output.hist2d
    xs, ns = np.nonzero((h2 > 0) & (np.arange(n + 1)[:, None] >= fused.min_sup))
    p = get_statistic(statistic).pvalue(xs, ns, n, n_pos)
    bound = 4 * EPS32 * float(np.log(np.arange(1, n + 1)).sum())
    named = {"count2d at alpha": fused.alpha, "test at delta": fused.delta}
    if "d" in gates:
        named["top-k final delta"] = report("d").delta
    for what, gate in named.items():
        rel = np.abs(p - gate) / gate
        i = int(np.argmin(rel))
        print(f"{statistic} {what} = {gate!r}: nearest of {len(xs)} counted cells "
              f"(support {xs[i]}, pos-support {ns[i]}) P = {p[i]!r}, "
              f"{rel[i]:.4%} away (float32 band {bound:.4%})")
        assert rel[i] > bound, what


def test_port_imports_no_jax_and_no_repro():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import repro_torch\n"
        "walked = []\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "    walked.append(m.name)\n"
        "print(json.dumps(walked))\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "      if m in ('jax', 'repro', 'ml_dtypes')\n"
        "      or m.startswith(('jax.', 'repro.', 'ml_dtypes.')))))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    walked, foreign = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert foreign == []
    # the serving layer is among what was imported
    assert {f"repro_torch.serve.{m}" for m in (
        "batch", "fleet", "loadgen", "request", "scheduler", "stats_util")} <= set(walked)
    assert "repro_torch.launch.mine_serve" in walked


def test_entry_points_raise_without_cuda():
    """Without a card, the entry points refuse instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch.core.engine import mine, pack_problem
    from repro_torch.kernels.support_count.ops import support_counts
    from repro_torch.results import build_result_set

    db = np.zeros((8, 4), dtype=bool)
    db[:4, :2] = True
    with pytest.raises(RuntimeError, match="cuda"):
        mine(db, np.arange(8) < 4, mode="count", min_sup=2)
    with pytest.raises(RuntimeError, match="cuda"):
        pack_problem(db)
    words = np.ones((2, 1), dtype=np.uint32)
    with pytest.raises(RuntimeError, match="cuda"):
        support_counts(words, words)
    with pytest.raises(RuntimeError, match="cuda"):
        build_result_set(words, [1, 1], [1, 1], words, n=8, n_pos=4, alpha=0.05,
                         min_sup=1, correction_factor=1, delta=0.05)


@pytest.mark.parametrize("b, m, w, name", [
    (10, 2048, 32, "mm/float16"), (1, 4097, 64, "mm/float16"),
    (7, 65, 65, "mm/float32"), (16, 33, 400, "mm/float32"),
    (17, 4095, 9, "_int_mm"), (24, 40, 1, "_int_mm")])
def test_chip_smoke_library_call_equals_plain(b, m, w, name):
    """The library yardstick chip_smoke.py times at every shape: the call it
    picks for (B, W) computes the plain version's S exactly (float16 only
    while every count fits its 11-bit significand)."""
    from repro_torch.kernels.support_count.ref import support_count_ref

    gen = torch.Generator().manual_seed(b * w)
    occ = torch.randint(-2**31, 2**31, (b, w), dtype=torch.int32, generator=gen)
    db = torch.randint(-2**31, 2**31, (m, w), dtype=torch.int32, generator=gen)
    occ[0] = -1
    db[m // 2] = -1
    lib, m_pad, got_name = _library(occ, db)
    assert got_name == name and m_pad >= m
    assert torch.equal(lib()[:, :m].to(torch.int32), support_count_ref(occ, db))


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a card, and
    when copied alone into an empty directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for script, cwd in ((os.path.join(ROOT, "chip_smoke.py"), ROOT),
                        (str(alone), str(tmp_path))):
        out = subprocess.run([sys.executable, script], capture_output=True,
                             text=True, env=env, cwd=cwd, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
