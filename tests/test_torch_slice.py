"""The port's slice end to end: the `fused23` query on hapmap_dom_20 at 1,191
items (chip_smoke.fused23 over repro_torch) against the JAX package's
`MinerSession.run(..., SignificantPatternQuery(pipeline="fused23"))`, on
the CPU at P = 1 — plus the port's import hygiene and its refusal to fall
back to the CPU.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.api import Dataset, MinerSession, SignificantPatternQuery  # noqa: E402
from repro.data.synthetic import paper_problem_packed as jax_paper_problem_packed  # noqa: E402
from repro_torch.core.engine import pack_problem_from_bits  # noqa: E402
from repro_torch.data.synthetic import paper_problem_packed  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import QUERY_EXPECT, fused23  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    torch's default of one thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fused23_query_matches_jax_session():
    bits, labels, _, spec = paper_problem_packed("hapmap_dom_20", scale_items=0.1)
    jbits, jlabels, _, _ = jax_paper_problem_packed("hapmap_dom_20", scale_items=0.1)
    np.testing.assert_array_equal(bits, jbits)   # same seed, same arrays
    np.testing.assert_array_equal(labels, jlabels)
    n = spec.n_transactions

    ds = Dataset.from_packed_words(jbits, jlabels, n_transactions=n)
    want = MinerSession(devices=jax.devices()[:1]).run(
        ds, SignificantPatternQuery(pipeline="fused23", statistic="fisher")
    )
    got = fused23(pack_problem_from_bits(bits, labels, n=n, device="cpu"),
                  n_miners=1)

    for f in ("lambda_final", "min_sup", "correction_factor", "delta",
              "n_significant"):
        assert got[f] == getattr(want, f), f
    for jph, ph in zip(want.phases, got["phases"]):
        a = jph.output
        np.testing.assert_array_equal(a.hist, ph.hist)
        assert (a.lam_final, a.supersteps) == (ph.lam_final, ph.supersteps)
        for name in a.stats:
            np.testing.assert_array_equal(a.stats[name], ph.stats[name], err_msg=name)
    a, b = want.phases[1].output, got["phases"][1]
    np.testing.assert_array_equal(a.hist2d, b.hist2d)
    w = b.sig_occ.shape[1]   # the session pads words to its shape bucket
    np.testing.assert_array_equal(a.sig_occ[:, :w], b.sig_occ)
    assert not a.sig_occ[:, w:].any()
    for f in ("sig_core", "sig_sup", "sig_pos_sup"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)

    rj, rt = want.results, got["results"]
    for f in ("n_transactions", "n_pos", "alpha", "min_sup", "correction_factor",
              "delta", "n_dropped", "item_names", "statistic", "truncated"):
        assert getattr(rt, f) == getattr(rj, f), f
    assert len(rt.patterns) == len(rj.patterns)
    for p, q in zip(rt.patterns, rj.patterns):
        assert (p.items, p.support, p.pos_support, p.pvalue, p.qvalue) == (
            q.items, q.support, q.pos_support, q.pvalue, q.qvalue)
    assert rt.to_tsv() == rj.to_tsv()
    assert rt.to_json() == rj.to_json()

    # the constants chip_smoke.py asserts on the card, from the JAX run
    for f, value in QUERY_EXPECT.items():
        assert getattr(want, f) == value, f
    assert len(rj) == QUERY_EXPECT["n_significant"]


def test_port_imports_no_jax_and_no_repro():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
        "      or m.startswith(('jax.', 'repro.')))))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


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
