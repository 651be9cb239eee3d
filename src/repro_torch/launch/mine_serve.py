"""Query-serving CLI of the port (counterpart of `repro.launch.mine_serve`):
N significant-pattern queries through `repro_torch.serve`.

  python -m repro_torch.launch.mine_serve --problem hapmap_dom_10 \
      --scale-items 0.02 --devices 8 --queries 16 --concurrency 2

A thin client of the async mining service (DESIGN.md §10): it pre-builds
the query workload (reseeded same-shape synthetic cohorts × a cycle of
significance levels), starts a `MiningService` — a fleet of
`--concurrency` warm sessions behind the admission-controlled scheduler —
warms the workload's shape bucket before any traffic, then drains the
queries closed-loop and prints per-query lines as results resolve.
`--concurrency 1` is the serial mode (one session, one in flight), the
like-for-like successor of the old in-process loop.

Every query should dispatch fully warm (the bucket is pre-compiled at
startup); queries that still compiled something are *counted* and
surfaced as `warm_violations` in the summary instead of tripping an
assert, so operators see degradation without the tool dying mid-run.

--device picks the device (cuda by default; without a card it refuses
rather than running on the CPU — pass --device cpu for that); every
session of the fleet runs on it, one CUDA stream each.  --devices N runs N
virtual miners per session (0 = one).  --kernel picks the support count:
the CUDA kernel (cuda), the plain PyTorch version (ref), or auto (cuda on
the card, ref on the CPU).

  --smoke        CI-sized: tiny scales, 4 queries (used by the slow-system job)
  --json-out     machine-readable latencies + cache stats
  --verbose      structured JSON-lines query records to stderr (repro_torch.obs)
  --metrics-out  Prometheus text snapshot of the shared service registry:
                 serve_* scheduler metrics + miner_* session metrics
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="hapmap_dom_10")
    ap.add_argument("--scale-items", type=float, default=0.02)
    ap.add_argument("--scale-trans", type=float, default=1.0)
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--alphas", default="0.05,0.01",
                    help="comma-separated significance levels cycled across queries")
    ap.add_argument("--pipeline", default="three_phase")
    ap.add_argument("--stat", default="fisher", choices=["fisher", "chi2"],
                    help="test statistic served by the sessions")
    ap.add_argument("--devices", type=int, default=0,
                    help="virtual miners per session (0 = one)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (cuda refuses without a card)")
    ap.add_argument("--expand-batch", type=int, default=16)
    ap.add_argument("--kernel", default="auto", choices=["auto", "ref", "cuda"],
                    help="support count (auto: cuda on the card, ref on the CPU)")
    ap.add_argument("--top-k", type=int, default=3,
                    help="patterns shown per query (0 = summary line only)")
    ap.add_argument("--concurrency", type=int, default=1,
                    help="session fleet size AND in-flight clients "
                         "(1 = serial serving)")
    ap.add_argument("--queue-capacity", type=int, default=64,
                    help="admission bound of the scheduler queue")
    ap.add_argument("--timeout-s", type=float, default=None,
                    help="per-query deadline (default: none)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized: tiny scales and 4 queries")
    ap.add_argument("--json-out", default="")
    ap.add_argument("--verbose", action="store_true",
                    help="stream structured JSON-lines query records to stderr")
    ap.add_argument("--metrics-out", default="",
                    help="write a Prometheus text-format metrics snapshot")
    args = ap.parse_args(argv)
    if args.queries < 1:
        ap.error("--queries must be >= 1")
    if args.concurrency < 1:
        ap.error("--concurrency must be >= 1")
    if args.smoke:
        args.scale_items = min(args.scale_items, 0.01)
        args.queries = min(args.queries, 4)

    from repro_torch.api import (
        PIPELINES, AlgorithmConfig, Dataset, RuntimeConfig,
        SignificantPatternQuery,
    )
    from repro_torch.obs import JsonlLogger
    from repro_torch.serve import (
        MiningService, ServeConfig, WarmupSpec, latency_histogram,
        percentile,
    )

    log = JsonlLogger() if args.verbose else None
    if args.pipeline not in PIPELINES:
        ap.error(f"--pipeline: unknown {args.pipeline!r}; "
                 f"available: {sorted(PIPELINES)}")
    alphas = [float(a) for a in args.alphas.split(",") if a]

    # the workload: reseeded same-shape cohorts (same bucket -> warm) at
    # cycling significance levels, built client-side before the clock
    work = []
    for q in range(args.queries):
        ds = Dataset.from_paper_problem(
            args.problem, args.scale_items, args.scale_trans, seed=q,
            device=args.device,
        )
        query = SignificantPatternQuery(
            alpha=alphas[q % len(alphas)], statistic=args.stat,
            pipeline=args.pipeline,
        )
        work.append((ds, query))

    service = MiningService(
        size=args.concurrency,
        n_miners=max(args.devices, 1),
        device=args.device,
        algorithm=AlgorithmConfig(pipeline=args.pipeline, statistic=args.stat),
        runtime=RuntimeConfig(expand_batch=args.expand_batch,
                              kernel_impl=args.kernel),
        config=ServeConfig(queue_capacity=args.queue_capacity,
                           default_timeout_s=args.timeout_s),
        warmups=[WarmupSpec(work[0][0].bucket, statistic=args.stat,
                            pipeline=args.pipeline)],
    )

    async def drive():
        t0 = time.perf_counter()
        compiled = await service.start()
        warmup_s = time.perf_counter() - t0
        n_dev = service.fleet.workers[0].session.n_devices
        print(f"[serve] fleet of {service.size} session(s) x {n_dev} miners, "
              f"pipeline={args.pipeline}, stat={args.stat}, alphas={alphas}; "
              f"warmup compiled {compiled} programs in {warmup_s:.2f}s")

        results: list = [None] * len(work)
        counter = iter(range(len(work)))

        async def client(cid: int):
            for q in counter:
                ds, query = work[q]
                res = await service.mine(ds, query, client=f"cli-{cid}")
                results[q] = res
                if res.ok or res.outcome == "partial":
                    rep = res.report
                    tag = ("partial" if res.outcome == "partial"
                           else "cold" if rep.cold else "warm")
                    print(f"[q{q:03d}] {tag} {res.total_s * 1e3:9.1f}ms  "
                          f"alpha={query.alpha:<5} min_sup={rep.min_sup} "
                          f"k={rep.correction_factor} "
                          f"significant={rep.n_significant} "
                          f"sess={res.session_id} "
                          f"batch={res.batch_index}/{res.batch_size}"
                          + (f" attempts={res.attempts}"
                             if res.attempts > 1 else ""))
                    if log:
                        log.event(
                            "query", q=q, cold=rep.cold,
                            outcome=res.outcome, attempts=res.attempts,
                            wall_s=round(res.total_s, 4),
                            queued_s=round(res.queued_s, 4),
                            service_s=round(res.service_s, 4),
                            alpha=query.alpha, min_sup=rep.min_sup,
                            k=rep.correction_factor,
                            significant=rep.n_significant,
                            kernel_impl=rep.kernel_impl,
                            session=res.session_id,
                            phase_wall_s=[round(p.wall_s, 4)
                                          for p in rep.phases],
                        )
                    if args.top_k:
                        for line in rep.results.describe(
                                args.top_k).splitlines()[1:]:
                            print("   " + line)
                else:
                    print(f"[q{q:03d}] {res.outcome} after "
                          f"{res.total_s * 1e3:9.1f}ms  ({res.reason})")
                    if log:
                        log.event("query", q=q, outcome=res.outcome,
                                  wall_s=round(res.total_s, 4))

        t_serve = time.perf_counter()
        await asyncio.gather(*[client(c) for c in range(args.concurrency)])
        total = time.perf_counter() - t_serve
        await service.stop()
        return results, total, warmup_s, compiled

    results, total, warmup_s, compiled = asyncio.run(drive())

    ok = [r for r in results if r is not None and r.ok]
    partial = [r for r in results
               if r is not None and r.outcome == "partial"]
    failed = [r for r in results
              if r is None or r.outcome not in ("ok", "partial")]
    retried = sum(1 for r in results
                  if r is not None and getattr(r, "attempts", 1) > 1)
    lat = [r.total_s for r in ok]
    # with startup warmup, *no* served query should ever compile — count
    # the ones that did instead of asserting (surfaced, not fatal)
    warm_violations = sum(1 for r in ok if r.report.cold)
    summary = {
        "problem": args.problem,
        "pipeline": args.pipeline,
        "statistic": args.stat,
        "concurrency": args.concurrency,
        "devices_per_session": (service.fleet.workers[0].session.n_devices),
        "queries": len(results),
        "ok": len(ok),
        "partial": len(partial),
        "retried": retried,
        "failed": len(failed),
        "total_wall_s": round(total, 3),
        "achieved_qps": round(len(ok) / total, 2) if total > 0 else None,
        "warmup_s": round(warmup_s, 3),
        "warmup_compiles": compiled,
        "warm_violations": warm_violations,
        "mean_s": round(sum(lat) / len(lat), 4) if lat else None,
        "p50_s": round(percentile(lat, 50), 4) if lat else None,
        "p90_s": round(percentile(lat, 90), 4) if lat else None,
        "max_s": round(max(lat), 4) if lat else None,
    }
    print("\n[latency] " + json.dumps(summary))
    print(latency_histogram(lat))
    infos = [w.session.cache_info() for w in service.fleet.workers]
    for w, ci in zip(service.fleet.workers, infos):
        print(f"session {w.wid}: {ci}")
    if warm_violations:
        print(f"[warn] {warm_violations} queries compiled despite warmup "
              "(warm_violations)", file=sys.stderr)
    if log:
        log.event("serve", **{k: v for k, v in summary.items()},
                  cache_hits=sum(ci.hits for ci in infos),
                  cache_misses=sum(ci.misses for ci in infos))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(service.metrics.expose_text())
        print(f"[out] wrote metrics snapshot to {args.metrics_out}")

    if args.json_out:
        payload = dict(
            summary,
            per_query_s=[round(r.total_s, 4) if r is not None else None
                         for r in results],
            cache={"hits": sum(ci.hits for ci in infos),
                   "misses": sum(ci.misses for ci in infos),
                   "programs": sum(ci.n_programs for ci in infos)},
        )
        with open(args.json_out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"[out] {args.json_out}")
    return 0 if not failed else 1


if __name__ == "__main__":
    sys.exit(main())
