"""The port's examples (`repro_torch.examples.quickstart`, `.gwas_mining`)
run with `--smoke --device cpu` and print what the JAX package's examples
print; the quickstart's oracle (`repro_torch.core.lamp`) gives the JAX
package's sequential oracle's answer."""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
from repro.core.lamp import lamp  # noqa: E402
from repro.data.synthetic import SyntheticSpec, generate  # noqa: E402
from repro_torch.core.lamp import lamp as port_lamp  # noqa: E402
from repro_torch.examples.quickstart import DEMO  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
           OMP_NUM_THREADS="1")


def _start(argv):
    return subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=ENV, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _lines(proc, timeout=300):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    return out.splitlines()


def test_quickstart_oracle_constants_are_the_oracles():
    """The quickstart's oracle, the port's LCM+LAMP on its demo matrix,
    gives the JAX oracle's values and patterns, P-values exactly."""
    db, labels, _ = generate(SyntheticSpec(**DEMO))
    want = lamp(db, labels, alpha=0.05)
    got = port_lamp(db, labels, alpha=0.05)
    assert (got.lambda_final, got.min_sup, got.correction_factor, got.delta) == (
        want.lambda_final, want.min_sup, want.correction_factor, want.delta)
    assert [(s.items, s.support, s.pos_support, s.pvalue) for s in got.significant] \
        == [(s.items, s.support, s.pos_support, s.pvalue) for s in want.significant]
    assert len(want.significant) == 147


def test_quickstart_prints_what_the_jax_example_prints():
    """Everything up to the warm repeat, which --smoke skips: the oracle's
    lines, the engine's values and top five, the planted recall, the OK."""
    procs = (_start([os.path.join("examples", "quickstart.py")]),
             _start(["-m", "repro_torch.examples.quickstart", "--smoke",
                     "--miners", "8", "--device", "cpu"]))
    want, got = (_lines(p) for p in procs)
    end = want.index("engine patterns match the sequential oracle — OK") + 1
    assert got == want[:end]


def _jax_gwas_lines(scale_items: float) -> list[str]:
    """The JAX example's P-independent lines at `scale_items`, from the
    calls it makes (one device)."""
    ds = japi.Dataset.from_paper_problem("hapmap_dom_10", scale_items, 1.0)
    spec = ds.spec
    session = japi.MinerSession(runtime=japi.RuntimeConfig(
        expand_batch=16, trace_period=1, trace_cap=8192))
    report = session.run(ds, japi.SignificantPatternQuery(alpha=0.05))
    before = session.cache_info()
    chi2 = session.run(ds, japi.SignificantPatternQuery(alpha=0.05, statistic="chi2"))
    extra = session.cache_info().misses - before.misses
    return [
        f"problem: {spec.name} scaled to {spec.n_items} items x "
        f"{spec.n_transactions} transactions (density {spec.density:.3f})",
        f"lambda={report.lambda_final} min_sup={report.min_sup} "
        f"k={report.correction_factor} significant={report.n_significant}",
        *report.results.describe(10, planted=ds.planted).splitlines(),
        f"chi2 query on the same session: significant={chi2.n_significant} "
        f"({extra} new compile{'s' if extra != 1 else ''} — "
        f"lamp1/count programs are statistic-free and stay warm)",
    ]


def test_gwas_mining_prints_what_the_jax_example_prints():
    """At --smoke's scale (0.005): the problem, the LAMP values, the top-10
    block with planted recovery, and the chi2 query's line with its one new
    program; then the per-miner, trace, naive and warm-repeat lines."""
    proc = _start(["-m", "repro_torch.examples.gwas_mining", "--smoke", "--device", "cpu"])
    want = _jax_gwas_lines(0.005)
    got = _lines(proc)
    assert got[0] == want[0]
    lamp_line = next(ln for ln in got if ln.startswith("three-phase LAMP in "))
    assert lamp_line.split(": ", 1)[1] == want[1]
    start = got.index(want[2])
    assert got[start:start + len(want) - 3] == want[2:-1]
    assert want[-1] in got
    for prefix in ("phase-2 work per miner: ", "phase-2 trace: ",
                   "naive split (no stealing): imbalance ", "warm repeat query ("):
        assert any(ln.startswith(prefix) for ln in got), prefix
