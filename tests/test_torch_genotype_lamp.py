"""The port's LAMP query on a genotype-shaped table: many items, few words.

The benchmark's `lamp_alz_dom_5` configuration runs `three_phase` with
Fisher's test on `alz_dom_5` (44,052 SNP items x 364 individuals, 12 words
a row, 16 in its bucket), drawn by the benchmark's generator at skew 4.0.  Held here, on the
CPU, at 3,000 items x 96 individuals from the same generator:

* the answer equals the benchmark's plain reference
  (`chipbench/reference/lamp.py::lamp_query`) at P = 1 and 8, with a push
  cap small enough that parents are resumed;
* each pass's `dispatch` span carries the candidate pass's work: `popped`
  is the pass's `PhaseReport.n_nodes`, `supersteps` its supersteps, and
  `rows` and `items` the rows and item columns one superstep scans;
* the configuration holds `alz_dom_5`'s Table 1 widths and lands in the
  bucket (512, 256, 65536).
"""

import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import repro_torch.api as tapi  # noqa: E402
from repro_torch.data.synthetic import PAPER_PROBLEMS  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chipbench.harness.synthetic import SyntheticSpec, generate_packed, unpack_words  # noqa: E402
from chipbench.reference.lamp import lamp_query  # noqa: E402

CONFIG = os.path.join(ROOT, "chipbench", "configs", "lamp_alz_dom_5.json")
#: 3,000 SNP items x 96 individuals (3 words), 46 cases, at the configuration's
#: density and skew
GENOTYPE = SyntheticSpec("genotype", 3000, 96, 0.054, 46, skew=4.0, seed=0)
#: a parent with more than 16 children among a superstep's pops is resumed
RUNTIME = dict(expand_batch=16, push_cap=16)
ALPHA = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """The reference's answer, the dataset, and {P: (session, report)}."""
    bits, labels, _ = generate_packed(GENOTYPE)
    ds = tapi.Dataset.from_packed_words(bits, labels, n_transactions=GENOTYPE.n_transactions,
                                        name="genotype", device="cpu")
    query = tapi.SignificantPatternQuery(alpha=ALPHA, pipeline="three_phase",
                                         statistic="fisher")
    out = {}
    for n_miners in (1, 8):
        s = tapi.MinerSession(n_miners, device="cpu", runtime=tapi.RuntimeConfig(**RUNTIME))
        out[n_miners] = (s, s.run(ds, query))
    db = unpack_words(bits, GENOTYPE.n_transactions).T
    return lamp_query(db, labels, ALPHA), ds, out


@pytest.mark.parametrize("n_miners", [1, 8])
def test_three_phase_equals_plain_reference_on_a_genotype_table(runs, n_miners):
    ref, _, out = runs
    rep = out[n_miners][1]
    assert ref["n_significant"] > 20
    assert (rep.lambda_final, rep.min_sup, rep.correction_factor, rep.n_significant) == (
        ref["lambda_final"], ref["min_sup"], ref["correction_factor"], ref["n_significant"])
    got = {p.items: p for p in rep.results}
    want = {p[0]: p for p in ref["patterns"]}
    assert got.keys() == want.keys()
    for items, (_, sup, pos, pv, qv) in want.items():
        p = got[items]
        assert (p.support, p.pos_support) == (sup, pos)
        assert p.pvalue == pytest.approx(pv, rel=1e-8)
        assert p.qvalue == pytest.approx(qv, rel=1e-8)
    # parents were resumed: an alive pop that is neither rejected by the
    # prefix check nor a closed set counted is a resume node
    stats = [p.output.stats for p in rep.phases]
    assert sum(int(s["popped"].sum() - s["rejected"].sum() - s["closed"].sum())
               for s in stats) > 0


@pytest.mark.parametrize("n_miners", [1, 8])
def test_dispatch_spans_carry_the_candidate_pass_work(runs, n_miners):
    _, ds, out = runs
    session, rep = out[n_miners]
    spans = [e for e in session.tracer.events() if e["name"] == "dispatch"]
    assert len(spans) == len(rep.phases) == 3
    cfg = session.runtime.resolve(ds.bucket, n_miners, session.device)
    for span, phase in zip(spans, rep.phases):
        args = span["args"]
        assert args["popped"] == phase.n_nodes > 0
        assert args["supersteps"] == phase.supersteps
        assert args["rows"] == n_miners * cfg.expand_batch
        assert args["items"] == ds.bucket.items == ds.packed.m_pad


def test_lamp_alz_dom_5_config_holds_the_table_1_widths():
    with open(CONFIG) as f:
        cfg = json.load(f)
    spec = PAPER_PROBLEMS["alz_dom_5"]
    d = cfg["dataset"]
    assert (d["name"], d["n_items"], d["n_transactions"], d["density"], d["n_pos"]) == (
        spec.name, spec.n_items, spec.n_transactions, spec.density, spec.n_pos)
    assert {k: d[k] for k in cfg["published"]} == cfg["published"]
    assert (d["n_planted"], d["planted_pos_rate"], d["planted_neg_rate"]) == (
        spec.n_planted, spec.planted_pos_rate, spec.planted_neg_rate)
    assert d["skew"] == 4.0 and any(a.startswith("skew 4.0") for a in cfg["assumed"])
    assert cfg["reduced"] == []
    assert cfg["query"] == {"kind": "significant", "pipeline": "three_phase",
                            "statistic": "fisher"}
    bucket = tapi.BucketPolicy().bucket_for(spec.n_transactions, spec.n_pos, spec.n_items)
    assert [bucket.transactions, bucket.positives, bucket.items] == cfg["bucket"] == [
        512, 256, 65536]
