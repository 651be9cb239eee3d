"""Quickstart: significant pattern mining (LAMP) on a small synthetic GWAS
matrix through the session API, held against the sequential oracle's
answer.  The port's counterpart of the JAX package's `examples/quickstart.py`.

  PYTHONPATH=src python -m repro_torch.examples.quickstart \
      [--miners 1] [--device cpu] [--smoke]

Shows the canonical API (repro_torch.api): a `Dataset` packed once onto
the device, a `MinerSession` whose programs are cached, first-class
`Query` objects executed via `session.run(...)` (a typed `MineReport`
each), and a second (warm) query that reuses every program.

The sequential oracle (the JAX package's host LCM+LAMP, `repro.core.lamp`)
is not ported, so this example carries its answer on the demo matrix as
constants (`ORACLE`), which tests/test_torch_examples.py re-derives from
the oracle.  It runs on the card by default; --device cpu runs it on the
CPU; --smoke skips the warm repeat query.
"""

from __future__ import annotations

import argparse
import hashlib
import json

#: the demo matrix (the JAX example's)
DEMO = dict(name="demo", n_items=120, n_transactions=300, density=0.06,
            n_pos=100, n_planted=2, planted_pos_rate=0.7,
            planted_neg_rate=0.03, seed=1)

#: the sequential oracle's answer on DEMO at alpha = 0.05: the LAMP values,
#: its first five significant itemsets (items, support, pos_support,
#: P-value), and the first 16 hex digits of the SHA-256 of all of them as
#: JSON, sorted [[items...], support, pos_support] (`pattern_digest`)
ORACLE = dict(lambda_final=10, min_sup=9, correction_factor=478,
              delta=0.00010460251046025105, n_significant=147,
              top=(((14, 69, 75, 88), 81, 73, 2.1091292202471404e-37),
                   ((69, 88), 83, 74, 2.3430458079770976e-37),
                   ((11,), 86, 75, 1.637430615225502e-36),
                   ((14, 88), 82, 73, 1.6881147383522794e-36),
                   ((11, 78, 84), 79, 71, 1.0259644982107697e-35)),
              patterns_sha256="eda75bc49973bed3")


def pattern_digest(patterns) -> str:
    """`patterns`: (items, support, pos_support) triples, any order."""
    rows = sorted((sorted(int(i) for i in items), int(s), int(ps))
                  for items, s, ps in patterns)
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()[:16]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--miners", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--smoke", action="store_true",
                    help="skip the warm repeat query")
    args = ap.parse_args(argv)

    from repro_torch.api import (
        Dataset,
        MinerSession,
        RuntimeConfig,
        SignificantPatternQuery,
    )
    from repro_torch.data.synthetic import SyntheticSpec, generate
    from repro_torch.results import score_planted

    spec = SyntheticSpec(**DEMO)
    db, labels, planted = generate(spec)
    print(f"dataset: {spec.n_items} items x {spec.n_transactions} transactions, "
          f"{spec.n_pos} positives; planted itemsets: {planted}")

    # --- the sequential reference's answer (constants, see ORACLE)
    ref = ORACLE
    print(f"\n[sequential] lambda={ref['lambda_final']} min_sup={ref['min_sup']} "
          f"closed@min_sup={ref['correction_factor']} delta={ref['delta']:.2e} "
          f"significant={ref['n_significant']}")
    for items, support, pos, pvalue in ref["top"]:
        print(f"   items={sorted(items)} support={support} "
              f"pos={pos} p={pvalue:.3e}")

    # --- the BSP engine behind the session API (--miners virtual miners)
    session = MinerSession(args.miners, device=args.device,
                           runtime=RuntimeConfig(expand_batch=16))
    ds = Dataset.from_dense(
        db, labels, name="demo",
        item_names=[f"snp{j:05d}" for j in range(spec.n_items)],
        device=args.device,
    )
    # session.run(dataset, query): the query object IS the objective —
    # swap statistic="chi2", or a ClosedFrequentQuery/TopKSignificantQuery,
    # without touching the engine (session.mine(ds) builds this same query)
    query = SignificantPatternQuery(alpha=0.05, statistic="fisher")
    report = session.run(ds, query)   # cold: builds one program per phase
    print(f"\n[engine]     lambda={report.lambda_final} min_sup={report.min_sup} "
          f"closed@min_sup={report.correction_factor} delta={report.delta:.2e} "
          f"significant={report.n_significant}")
    rs = report.results  # the mined patterns themselves, not just the count
    for p in rs.top(5):
        print(f"   items={rs.names_of(p)} support={p.support} "
              f"pos={p.pos_support} p={p.pvalue:.3e} q={p.qvalue:.3e}")
    score = score_planted(rs, planted)
    print(f"planted itemsets recovered: {len(score['recovered'])}/"
          f"{score['n_planted']} (recall {score['recall']:.2f})")

    assert report.min_sup == ref["min_sup"]
    assert report.correction_factor == ref["correction_factor"]
    assert report.n_significant == ref["n_significant"]
    got = pattern_digest((p.items, p.support, p.pos_support) for p in rs)
    assert got == ref["patterns_sha256"], \
        "engine pattern identities must match the oracle"
    print("\nengine patterns match the sequential oracle — OK")
    if args.smoke:
        return 0

    # --- repeat query on a warm session: zero new builds
    db2, labels2, _ = generate(SyntheticSpec(**dict(DEMO, name="demo2", seed=2)))
    before = session.cache_info()
    report2 = session.run(Dataset.from_dense(db2, labels2, name="demo2",
                                             device=args.device), query)
    after = session.cache_info()
    assert after.misses == before.misses, "warm query must not rebuild"
    print(f"warm repeat query: {report2.wall_s:.3f}s vs cold "
          f"{report.wall_s:.3f}s — zero new compiles "
          f"({after.hits} cache hits)\n{after}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
