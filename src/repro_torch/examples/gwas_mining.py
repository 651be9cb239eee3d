"""End-to-end GWAS-style significant pattern mining at paper-problem scale,
on the session API.  The port's counterpart of the JAX package's
`examples/gwas_mining.py`.

  PYTHONPATH=src python -m repro_torch.examples.gwas_mining \
      [--miners 8] [--scale-items 0.05] [--smoke] [--device cpu]

Demonstrates: the three LAMP phases on a Table-1-matched problem via a
build-once `MinerSession` driven by first-class `Query` objects, the mined
itemsets printed with SNP names, a chi-square query reusing the warm
lamp1/count programs (only the statistic's own test program is built),
the GLB vs naive comparison, and a warm repeat query with zero rebuilds.

It runs on the card by default; --device cpu runs it on the CPU.  --smoke
shrinks the problem to a tenth of the default items.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--miners", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--scale-items", type=float, default=0.05)
    ap.add_argument("--smoke", action="store_true",
                    help="a tenth of the items (0.005 of the paper's)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.scale_items = min(args.scale_items, 0.005)

    from repro_torch.api import (
        Dataset,
        MinerSession,
        RuntimeConfig,
        SignificantPatternQuery,
    )

    ds = Dataset.from_paper_problem("hapmap_dom_10", args.scale_items, 1.0,
                                    device=args.device)
    spec = ds.spec
    print(f"problem: {spec.name} scaled to {spec.n_items} items x "
          f"{spec.n_transactions} transactions (density {spec.density:.3f})")

    session = MinerSession(
        args.miners, device=args.device,
        runtime=RuntimeConfig(expand_batch=16, trace_period=1, trace_cap=8192),
    )
    t0 = time.time()
    report = session.run(ds, SignificantPatternQuery(alpha=0.05))
    print(f"\nthree-phase LAMP in {time.time()-t0:.1f}s: "
          f"lambda={report.lambda_final} min_sup={report.min_sup} "
          f"k={report.correction_factor} significant={report.n_significant}")

    print("\n" + report.results.describe(10, planted=ds.planted))

    # same engine, different test: the chi-square query shares the session's
    # warm lamp1/count programs — only its own emission test is built
    before = session.cache_info()
    rep_chi2 = session.run(ds, SignificantPatternQuery(alpha=0.05,
                                                       statistic="chi2"))
    extra = session.cache_info().misses - before.misses
    print(f"\nchi2 query on the same session: "
          f"significant={rep_chi2.n_significant} "
          f"({extra} new compile{'s' if extra != 1 else ''} — "
          f"lamp1/count programs are statistic-free and stay warm)")

    p2 = report.phases[1]
    work = p2.stats["popped"]
    print(f"phase-2 work per miner: min={work.min()} mean={work.mean():.0f} "
          f"max={work.max()}  (imbalance {work.max()/max(work.mean(),1):.2f}x, "
          f"steals={p2.steals})")

    # the decoded device superstep trace (DESIGN.md §9): the paper's "evenly
    # distributed communication" claim, measured per superstep per miner
    tr = p2.trace
    print(f"phase-2 trace: {tr.n_steps} supersteps sampled, steal exchange "
          f"fired {int(tr.fired.sum())}x, donation fairness "
          f"{tr.donation_fairness():.2f}, work fairness "
          f"{tr.work_fairness():.2f}, idle fraction "
          f"{tr.idle_fraction().mean():.2f} mean")

    # paper §5.4: same search without stealing — a separate runtime config,
    # hence separate programs, in a session of its own
    naive_session = MinerSession(
        args.miners, device=args.device,
        runtime=RuntimeConfig(expand_batch=16, steal_enabled=False),
    )
    naive = naive_session.run_phase(ds, "count", min_sup=report.min_sup)
    nwork = naive.output.stats["popped"]
    print(f"naive split (no stealing): imbalance "
          f"{nwork.max()/max(nwork.mean(),1):.2f}x  — the paper's §5.4 gap")

    # warm repeat: a fresh same-shape dataset reuses every program
    ds2 = Dataset.from_paper_problem("hapmap_dom_10", args.scale_items, 1.0,
                                     seed=1, device=args.device)
    before = session.cache_info()
    rep2 = session.run(ds2, SignificantPatternQuery(alpha=0.05))
    assert session.cache_info().misses == before.misses
    print(f"\nwarm repeat query ({ds2.name} reseeded): {rep2.wall_s:.2f}s vs "
          f"cold {report.wall_s:.2f}s, zero new compiles")
    print(session.cache_info())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
