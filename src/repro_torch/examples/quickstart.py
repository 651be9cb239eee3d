"""Quickstart: significant pattern mining (LAMP) on a small synthetic GWAS
matrix — the sequential oracle vs the session API's BSP engine.  The
port's counterpart of the JAX package's `examples/quickstart.py`.

  PYTHONPATH=src python -m repro_torch.examples.quickstart \
      [--miners 1] [--device cpu] [--smoke]

Shows the canonical API (repro_torch.api): a `Dataset` packed once onto
the device, a `MinerSession` whose programs are cached, first-class
`Query` objects executed via `session.run(...)` (a typed `MineReport`
each), and a second (warm) query that reuses every program.

The sequential oracle is the host LCM+LAMP of `repro_torch.core.lamp`.
The engine runs on the card by default; --device cpu runs it on the CPU;
--smoke skips the warm repeat query.
"""

from __future__ import annotations

import argparse

#: the demo matrix (the JAX example's)
DEMO = dict(name="demo", n_items=120, n_transactions=300, density=0.06,
            n_pos=100, n_planted=2, planted_pos_rate=0.7,
            planted_neg_rate=0.03, seed=1)


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
    from repro_torch.core.lamp import lamp
    from repro_torch.data.synthetic import SyntheticSpec, generate
    from repro_torch.results import score_planted

    spec = SyntheticSpec(**DEMO)
    db, labels, planted = generate(spec)
    print(f"dataset: {spec.n_items} items x {spec.n_transactions} transactions, "
          f"{spec.n_pos} positives; planted itemsets: {planted}")

    # --- sequential reference (host numpy LCM+LAMP)
    ref = lamp(db, labels, alpha=0.05)
    print(f"\n[sequential] lambda={ref.lambda_final} min_sup={ref.min_sup} "
          f"closed@min_sup={ref.correction_factor} delta={ref.delta:.2e} "
          f"significant={len(ref.significant)}")
    for s in ref.significant[:5]:
        print(f"   items={sorted(s.items)} support={s.support} "
              f"pos={s.pos_support} p={s.pvalue:.3e}")

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

    assert report.min_sup == ref.min_sup
    assert report.correction_factor == ref.correction_factor
    assert report.n_significant == len(ref.significant)
    got = {(p.items, p.support, p.pos_support) for p in rs}
    want = {(tuple(sorted(s.items)), s.support, s.pos_support)
            for s in ref.significant if s.items}
    assert got == want, "engine pattern identities must match the oracle"
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
