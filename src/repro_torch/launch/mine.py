"""Pattern-mining launcher of the port (counterpart of `repro.launch.mine`).

  python -m repro_torch.launch.mine --problem hapmap_dom_10 --scale-items 0.02 \
      --devices 8 --alpha 0.05

One-shot front-end over the query API (`repro_torch.api`): builds a
`Dataset` (packed once onto the device, SNP-style item names) and a
`MinerSession`, runs one query object, and prints the typed `MineReport`
and the same JSON blob as the JAX launcher.  The objective is selectable:

  --query significant       LAMP staging at --alpha (default)
  --query closed-frequent   every closed itemset with support >= --min-sup
  --query topk              the --k most significant patterns, alpha-free

and so is the test statistic (--stat fisher|chi2) for the testing
objectives.

--devices N runs N virtual miners on the one device (0 = one miner);
--device picks the device (cuda by default; without a card it refuses
rather than running on the CPU — pass --device cpu for that).  --kernel
picks the support count: the CUDA kernel (cuda), the plain PyTorch version
(ref), or auto (cuda on the card, ref on the CPU).  --no-steal reproduces
the paper's naive baseline.  --top-k prints the most significant mined
itemsets and --patterns-out exports the full ResultSet as TSV/JSON.
--verbose streams JSON-lines run records to stderr, --trace-out saves the
host span timeline as Chrome-trace JSON and --metrics-out the session's
Prometheus metrics.

The device superstep trace (--trace-period/--trace-cap), checkpoints
(--ckpt-dir/--ckpt-period/--resume) and multi-host shapes
(--hosts/--devices-per-host) are not ported yet; those flags exit with an
error naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

#: flags of features the port does not have yet -> their ROADMAP.md item
_UNPORTED = (
    (("trace_period", "trace_cap"), "--trace-period/--trace-cap",
     "queue 1, item 7: observability (the superstep trace ring)"),
    (("ckpt_dir", "ckpt_period", "resume"), "--ckpt-dir/--ckpt-period/--resume",
     "queue 1, item 8: fault tolerance"),
    (("hosts", "devices_per_host"), "--hosts/--devices-per-host",
     "queue 1, item 10: multi-process topology"),
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="hapmap_dom_10")
    ap.add_argument("--scale-items", type=float, default=0.02)
    ap.add_argument("--scale-trans", type=float, default=1.0)
    ap.add_argument("--alpha", type=float, default=0.05)
    ap.add_argument("--query", default="significant",
                    choices=["significant", "closed-frequent", "topk"],
                    help="mining objective (a repro_torch.api.QUERIES key)")
    ap.add_argument("--stat", default="fisher", choices=["fisher", "chi2"],
                    help="test statistic (a repro_torch.stats registry key; "
                         "ignored by --query closed-frequent)")
    ap.add_argument("--min-sup", type=int, default=0,
                    help="support threshold for --query closed-frequent "
                         "(required there; ignored elsewhere)")
    ap.add_argument("--k", type=int, default=10,
                    help="patterns to mine for --query topk")
    ap.add_argument("--devices", type=int, default=0,
                    help="virtual miners on the one device (0 = one)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (cuda refuses without a card)")
    ap.add_argument("--hosts", type=int, default=0, help="not ported yet")
    ap.add_argument("--devices-per-host", type=int, default=0,
                    help="not ported yet")
    ap.add_argument("--no-steal", action="store_true")
    ap.add_argument("--expand-batch", type=int, default=16)
    ap.add_argument("--steal-max", type=int, default=128)
    ap.add_argument("--stack-cap", type=int, default=0,
                    help="per-miner stack capacity (0 = auto-size)")
    ap.add_argument("--kernel", default="auto", choices=["auto", "ref", "cuda"],
                    help="support count (auto: cuda on the card, ref on the CPU)")
    ap.add_argument("--sync-period", type=int, default=4,
                    help="supersteps between lambda/histogram syncs "
                         "(staleness costs work, never results)")
    ap.add_argument("--pipeline", default="three_phase",
                    help="LAMP pipeline (an api.PIPELINES key, e.g. "
                         "three_phase | fused23)")
    ap.add_argument("--top-k", type=int, default=10,
                    help="print the k most significant mined patterns")
    ap.add_argument("--patterns-out", default="",
                    help="write the full mined ResultSet (.tsv or .json)")
    ap.add_argument("--out-cap", type=int, default=4096,
                    help="per-miner pattern emission buffer capacity")
    ap.add_argument("--json-out", default="")
    ap.add_argument("--verbose", action="store_true",
                    help="stream structured JSON-lines run records to stderr")
    ap.add_argument("--trace-period", type=int, default=0, help="not ported yet")
    ap.add_argument("--trace-cap", type=int, default=0, help="not ported yet")
    ap.add_argument("--trace-out", default="",
                    help="write the host span timeline as Chrome-trace JSON")
    ap.add_argument("--metrics-out", default="",
                    help="write a Prometheus text-format metrics snapshot")
    ap.add_argument("--ckpt-dir", default="", help="not ported yet")
    ap.add_argument("--ckpt-period", type=int, default=0, help="not ported yet")
    ap.add_argument("--resume", default="", help="not ported yet")
    args = ap.parse_args(argv)

    for dests, flags, item in _UNPORTED:
        if any(getattr(args, d) for d in dests):
            ap.error(f"{flags}: not ported yet (ROADMAP.md {item})")
    if args.query == "closed-frequent" and args.min_sup < 1:
        ap.error("--query closed-frequent needs --min-sup N (N >= 1): the "
                 "objective is every closed itemset with support >= N")

    from repro_torch.api import (
        PIPELINES,
        AlgorithmConfig,
        ClosedFrequentQuery,
        Dataset,
        MinerSession,
        RuntimeConfig,
        SignificantPatternQuery,
        TopKSignificantQuery,
    )
    from repro_torch.obs import JsonlLogger
    from repro_torch.results import score_planted

    if args.pipeline not in PIPELINES:
        ap.error(f"--pipeline: unknown {args.pipeline!r}; "
                 f"available: {sorted(PIPELINES)}")

    log = JsonlLogger() if args.verbose else None
    ds = Dataset.from_paper_problem(
        args.problem, args.scale_items, args.scale_trans, device=args.device
    )
    spec = ds.spec
    print(f"[data] {spec.name}: {spec.n_items} items x {spec.n_transactions} "
          f"transactions, density {spec.density:.3f}, N_pos {spec.n_pos}")
    if log:
        log.event("data", problem=spec.name, items=spec.n_items,
                  transactions=spec.n_transactions, n_pos=spec.n_pos,
                  density=round(spec.density, 4))

    session = MinerSession(
        max(args.devices, 1),
        device=args.device,
        algorithm=AlgorithmConfig(alpha=args.alpha, statistic=args.stat,
                                  pipeline=args.pipeline),
        runtime=RuntimeConfig(
            expand_batch=args.expand_batch,
            steal_max=args.steal_max,
            steal_enabled=not args.no_steal,
            kernel_impl=args.kernel,
            sync_period=args.sync_period,
            out_cap=args.out_cap,
            # stack_cap=None: sized by RuntimeConfig.resolve for the
            # dataset's bucket and the miner count
            stack_cap=args.stack_cap or None,
        ),
    )
    if args.query == "closed-frequent":
        query = ClosedFrequentQuery(min_sup=args.min_sup)
    elif args.query == "topk":
        query = TopKSignificantQuery(k=args.k, statistic=args.stat)
    else:
        query = SignificantPatternQuery(
            alpha=args.alpha, statistic=args.stat, pipeline=args.pipeline
        )
    t0 = time.time()
    report = session.run(ds, query)
    dt = time.time() - t0
    if log:
        for p in report.phases:
            log.event(
                "phase", mode=p.mode, wall_s=round(p.wall_s, 4),
                compile_s=round(p.compile_s, 4), cache_hit=p.cache_hit,
                supersteps=p.supersteps, lam_final=p.lam_final,
                n_nodes=p.n_nodes, steal_rounds=p.steal_rounds,
                kernel_impl=p.kernel_impl, kernel_blocks=p.kernel_blocks,
                item_tile=p.item_tile, emit_dropped=p.emit_dropped,
                trace_dropped=p.trace_dropped,
            )
    # per-miner work telemetry: the count phase for the LAMP staging
    # (phases[1], the historical meaning of these JSON keys); objectives
    # with a single/variable staging report their last traversal
    work_phase = (report.phases[1] if report.query == "significant"
                  and len(report.phases) > 1 else report.phases[-1]).output
    rs = report.results
    out = {
        "problem": spec.name,
        "query": report.query,
        "statistic": report.statistic,
        "pipeline": report.pipeline,
        "lambda": report.lambda_final,
        "min_sup": report.min_sup,
        "closed_sets": report.correction_factor,
        "delta": None if math.isnan(report.delta) else report.delta,
        "significant": report.n_significant,
        "patterns": len(rs),
        "patterns_complete": rs.complete,
        "wall_s": round(dt, 3),
        "supersteps": [p.supersteps for p in report.phases],
        "per_device_popped": work_phase.stats["popped"].tolist(),
        "steals": int(sum(work_phase.stats["steals_got"])),
    }
    if report.query == "significant":
        out["planted_recall"] = score_planted(rs, ds.planted)["recall"]
    print(json.dumps(out, indent=1, default=str))
    if log:
        ci = session.cache_info()
        log.event("run", **out,
                  cache={"hits": ci.hits, "misses": ci.misses,
                         "evictions": ci.evictions,
                         "programs": ci.n_programs})

    planted = ds.planted if report.statistic is not None else None
    print("\n" + rs.describe(args.top_k, planted=planted))

    if args.patterns_out:
        rs.save(args.patterns_out)
        print(f"[out] wrote {len(rs)} patterns to {args.patterns_out}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, default=str)
    if args.trace_out:
        session.tracer.save(args.trace_out)
        print(f"[out] wrote host span timeline to {args.trace_out} "
              "(open in ui.perfetto.dev)")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(session.metrics.expose_text())
        print(f"[out] wrote metrics snapshot to {args.metrics_out}")


if __name__ == "__main__":
    sys.exit(main())
