"""The port's three_phase LAMP query decides its emission gate in float64.

The test pass's float32 device P-value may lie a few ulps of
log Gamma(N + 1) from the exact one: 10% of the gate at N = 12,773.  The
session gates that pass at delta * exp(gate_rtol(N)), a superset of the
significant records, and keeps on the host the records of float64 P-value
<= delta (the `refilter` span), whose P-values the results layer takes
over.  Held here, on the CPU:

* the answer equals the benchmark's plain reference
  (`chipbench/reference/lamp.py::lamp_query`) at P = 1 and 8 on a
  long-transaction dataset (2,400 transactions, W = 75 words);
* with delta between a record's float32 and float64 P-values, the record
  is reported exactly when its float64 P-value clears delta, where the
  float32 test alone decides the other way;
* a test pass cut by a soft deadline is decided on the host too;
* a streamed build of the answer equals the whole one;
* the device P-value lies within the band at `mcf7`'s margins;
* the benchmark's `lamp_mcf7` configuration holds `mcf7`'s Table 1 widths.
"""

import json
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.api as tapi  # noqa: E402
from repro_torch.data.synthetic import PAPER_PROBLEMS, SyntheticSpec, generate  # noqa: E402
from repro_torch.stats import EPS32, fisher_pvalue, fisher_pvalue_torch, gate_rtol  # noqa: E402
from repro_torch.stats import get_statistic  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chipbench.reference.closed import closed_itemsets  # noqa: E402
from chipbench.reference.lamp import lamp_query  # noqa: E402

#: 48 items x 2,400 transactions, 200 positives: W = 75 words a row
LONG = SyntheticSpec("long", 48, 2400, 0.05, 200, 3, seed=0)
RUNTIME = dict(expand_batch=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    torch's default of one thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def long_data():
    db, labels, _ = generate(LONG)
    ds = tapi.Dataset.from_dense(db, labels, name="long", device="cpu",
                                 bucket_policy=tapi.BucketPolicy(exact=True))
    assert ds.packed.w_pad == 75
    return db, labels, ds


@pytest.fixture(scope="module")
def at_05(long_data):
    """The reference's answer at alpha 0.05, and {P: (session, report)}."""
    db, labels, ds = long_data
    runs = {}
    for n_miners in (1, 8):
        s = session(n_miners)
        runs[n_miners] = (s, s.run(ds, three_phase(0.05)))
    return lamp_query(db, labels, 0.05), runs


def session(n_miners, **runtime):
    return tapi.MinerSession(n_miners, device="cpu",
                             runtime=tapi.RuntimeConfig(**RUNTIME, **runtime))


def three_phase(alpha):
    return tapi.SignificantPatternQuery(alpha=alpha, pipeline="three_phase",
                                        statistic="fisher")


def assert_equals_reference(rep, ref):
    assert (rep.lambda_final, rep.min_sup, rep.correction_factor, rep.n_significant) == (
        ref["lambda_final"], ref["min_sup"], ref["correction_factor"],
        ref["n_significant"])
    got = {p.items: p for p in rep.results}
    want = {p[0]: p for p in ref["patterns"]}
    assert got.keys() == want.keys()
    for items, (_, sup, pos, pv, qv) in want.items():
        p = got[items]
        assert (p.support, p.pos_support) == (sup, pos)
        assert p.pvalue == pytest.approx(pv, rel=1e-8)
        assert p.qvalue == pytest.approx(qv, rel=1e-8)


@pytest.mark.parametrize("n_miners", [1, 8])
def test_three_phase_equals_plain_reference_on_long_transactions(n_miners, at_05):
    ref, runs = at_05
    assert ref["n_significant"] > 100
    assert_equals_reference(runs[n_miners][1], ref)


def test_decision_follows_float64_inside_the_band(long_data, at_05):
    """delta between a record's float32 device P-value and its float64 one:
    the float32 test alone would decide the record the other way."""
    db, labels, ds = long_data
    n, n_pos = ds.n_transactions, ds.n_pos
    base = at_05[1][1][1]
    k, delta0 = base.correction_factor, base.delta
    found = closed_itemsets(db, labels, base.min_sup)
    sup = np.array([f[1] for f in found])
    pos = np.array([f[2] for f in found])
    p64 = fisher_pvalue(sup, pos, n, n_pos)
    p32 = fisher_pvalue_torch(torch.from_numpy(sup), torch.from_numpy(pos), n, n_pos,
                              k_max=n_pos).double().numpy()
    # the record near delta0 whose float32 P-value strays the furthest
    near = np.flatnonzero(np.abs(np.log(p64 / delta0)) < 0.4)
    i = near[np.argmax(np.abs(np.log(p32[near] / p64[near])))]
    assert abs(math.log(p32[i] / p64[i])) > 1e-5, "no float32 P-value strays here"
    assert abs(math.log(p32[i] / p64[i])) <= gate_rtol(n)
    rep = session(1).run(ds, three_phase(math.sqrt(p32[i] * p64[i]) * k))
    assert (rep.lambda_final, rep.correction_factor) == (base.lambda_final, k)
    delta = rep.delta
    assert (p32[i] <= delta) != (p64[i] <= delta)
    assert (found[i][0] in {p.items for p in rep.results}) == (p64[i] <= delta)
    assert rep.n_significant == len(rep.results) == int((p64 <= delta).sum())
    assert_equals_reference(rep, lamp_query(db, labels, delta * k))


def test_refilter_span_and_counter(long_data, at_05):
    """The test pass emits at delta * exp(gate_rtol(N)); `refilter` counts
    what it emitted, kept and dropped, the counter adds up the dropped, and
    the pass's output holds the records at delta."""
    _, _, ds = long_data
    s, rep = at_05[1][8]
    (span,) = [e for e in s.tracer.events() if e["name"] == "refilter"]
    (query,) = [e for e in s.tracer.events() if e["name"].startswith("query:")]
    assert query["ts"] <= span["ts"] and span["ts"] + span["dur"] <= query["ts"] + query["dur"]
    a = span["args"]
    out = rep.phases[2].output
    assert a["kept"] == rep.n_significant == len(rep.results) == len(out.sig_sup)
    assert a["emitted"] == a["kept"] + a["band"] and out.sig_count == rep.n_significant
    p = get_statistic("fisher").pvalue(out.sig_sup, out.sig_pos_sup,
                                       ds.n_transactions, ds.n_pos)
    assert np.all(p <= rep.delta)
    text = s.metrics.expose_text()
    assert f"miner_gate_band_records_total {a['band']}" in text
    # `distinct` counts the (sup, pos_sup) pairs among the emitted records:
    # the test pass again, on a session of its own, without the host decision
    emitted = session(8).run_phase(ds, "test", min_sup=rep.min_sup, delta=rep.delta,
                                   alpha=0.05, statistic="fisher",
                                   band=gate_rtol(ds.n_transactions)).output
    assert len(emitted.sig_sup) == a["emitted"]
    pairs = set(zip(emitted.sig_sup.tolist(), emitted.sig_pos_sup.tolist()))
    assert a["distinct"] == len(pairs) <= a["emitted"]
    assert a["distinct"] >= len(set(zip(out.sig_sup.tolist(), out.sig_pos_sup.tolist())))


def test_soft_stop_in_the_test_pass_is_decided_on_the_host(long_data, at_05, tmp_path):
    _, _, ds = long_data
    full = at_05[1][1][1]
    before = sum(p.supersteps for p in full.phases[:2])
    polls = {"n": 0}

    def stop():
        polls["n"] += 1
        return polls["n"] > before + full.phases[2].supersteps // 2

    rep = session(1, ckpt_period=1).run(ds, three_phase(0.05),
                                        ckpt_dir=str(tmp_path), should_stop=stop)
    assert rep.partial and rep.phases[-1].mode == "test" and rep.results.truncated
    assert 0 < len(rep.results) < len(full.results)
    assert rep.n_significant == len(rep.results)
    assert all(p.pvalue <= rep.delta for p in rep.results)
    want = {p.items for p in full.results}
    assert {p.items for p in rep.results} <= want


def test_a_streamed_answer_equals_the_whole_one(long_data, at_05):
    from repro_torch.results import ResultStream

    _, _, ds = long_data
    s, rep = at_05[1][1]
    heads = []
    got = s.run(ds, three_phase(0.05), stream=ResultStream(head_k=5, chunk=64,
                                                           on_head=heads.append))
    assert len(heads) == 1 and heads[0] == got.results.patterns[:5]
    assert got.results.to_json() == rep.results.to_json()


@pytest.mark.parametrize("statistic", ["fisher", "chi2"])
def test_device_pvalues_within_the_band_at_mcf7_margins(statistic):
    spec = PAPER_PROBLEMS["mcf7"]
    N, N_pos = spec.n_transactions, spec.n_pos
    rng = np.random.default_rng(2)
    x = rng.integers(1, 400, 2000)                 # mcf7's closed sets: support < 400
    n = np.minimum(rng.integers(0, 200, 2000), x)
    stat = get_statistic(statistic)
    exact = stat.pvalue(x, n, N, N_pos)
    got = stat.pvalue_device(torch.from_numpy(x), torch.from_numpy(n), N, N_pos,
                             k_max=2048).double().numpy()
    live = (exact > 1e-36) & (got > 1e-36)
    dlog = np.abs(np.log(got[live]) - np.log(exact[live]))
    band = gate_rtol(N)
    assert band == pytest.approx(0.1030, abs=1e-4)
    assert dlog.max() <= (band - EPS32) / 2, (dlog.max(), band)


def test_lamp_mcf7_config_holds_the_table_1_widths():
    with open(os.path.join(ROOT, "chipbench", "configs", "lamp_mcf7.json")) as f:
        cfg = json.load(f)
    spec = PAPER_PROBLEMS["mcf7"]
    d = cfg["dataset"]
    assert (d["name"], d["n_items"], d["n_transactions"], d["density"], d["n_pos"]) == (
        spec.name, spec.n_items, spec.n_transactions, spec.density, spec.n_pos)
    assert {k: d[k] for k in cfg["published"]} == cfg["published"]
    assert (d["n_planted"], d["planted_pos_rate"], d["planted_neg_rate"], d["skew"]) == (
        spec.n_planted, spec.planted_pos_rate, spec.planted_neg_rate, spec.skew)
    assert cfg["reduced"] == []
    assert cfg["query"] == {"kind": "significant", "pipeline": "three_phase",
                            "statistic": "fisher"}
    bucket = tapi.BucketPolicy().bucket_for(spec.n_transactions, spec.n_pos, spec.n_items)
    assert [bucket.transactions, bucket.positives, bucket.items] == cfg["bucket"]
