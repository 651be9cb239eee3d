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
--verbose streams JSON-lines run records to stderr; --trace-period N
samples the device superstep trace every N supersteps and adds its
load-balance summary to the blob; --trace-out saves the host span timeline
as Chrome-trace JSON and --metrics-out the session's Prometheus metrics.
--profile-out runs the query under torch.profiler (the host, and the card
where there is one) with the session's spans bridged into it, and writes
one Chrome trace in which the spans sit beside the operators and kernels
they launched, on the profiler's clock.

Fault tolerance (DESIGN.md §11): --ckpt-period N runs every phase in
segments of N supersteps, --ckpt-dir writes a frontier checkpoint at each
segment boundary, and --resume restores the newest valid one (written by
this launcher or the JAX one; elastic: the frontier is re-dealt onto
--devices miners).

--hosts H --devices-per-host D simulates an H x D machine in one process
(repro_torch.topo): H*D virtual miners under the hierarchical two-level
lifeline schedule.  The results equal the flat run's; the supersteps,
steals and per-round steal telemetry are the JAX launcher's at the same
flags.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time

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
    ap.add_argument("--hosts", type=int, default=0,
                    help="simulate a hosts x devices-per-host machine "
                         "(repro_torch.topo): hierarchical two-level "
                         "lifeline schedule, single process")
    ap.add_argument("--devices-per-host", type=int, default=0,
                    help="miners per simulated host (with --hosts)")
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
    ap.add_argument("--trace-period", type=int, default=0,
                    help="sample the device superstep trace every N "
                         "supersteps (0 = off)")
    ap.add_argument("--trace-cap", type=int, default=0,
                    help="trace ring slots per miner (0 = default when "
                         "tracing)")
    ap.add_argument("--trace-out", default="",
                    help="write the host span timeline as Chrome-trace JSON")
    ap.add_argument("--metrics-out", default="",
                    help="write a Prometheus text-format metrics snapshot")
    ap.add_argument("--profile-out", default="",
                    help="profile the query with torch.profiler and write "
                         "its Chrome trace, the session's spans beside the "
                         "kernels")
    ap.add_argument("--ckpt-dir", default="",
                    help="write frontier checkpoints under this directory "
                         "(requires --ckpt-period)")
    ap.add_argument("--ckpt-period", type=int, default=0,
                    help="supersteps between frontier checkpoints "
                         "(0 = off; enables the segmented engine)")
    ap.add_argument("--resume", default="",
                    help="resume from the newest valid checkpoint under "
                         "this directory (elastic: the saved frontier is "
                         "re-dealt onto the current miner count)")
    args = ap.parse_args(argv)

    if (args.ckpt_dir or args.resume) and args.ckpt_period < 1:
        ap.error("--ckpt-dir/--resume need --ckpt-period N (N >= 1): "
                 "checkpoints are cut at segment boundaries of the "
                 "segmented engine")
    if args.query == "closed-frequent" and args.min_sup < 1:
        ap.error("--query closed-frequent needs --min-sup N (N >= 1): the "
                 "objective is every closed itemset with support >= N")

    topology = None
    if args.hosts or args.devices_per_host:
        if args.hosts < 1 or args.devices_per_host < 1:
            ap.error("--hosts and --devices-per-host go together (both >= 1)")
        from repro_torch.topo import Topology

        topology = Topology(args.hosts, args.devices_per_host)
        if args.devices and args.devices != topology.n_proc:
            ap.error(f"--devices {args.devices} contradicts --hosts x "
                     f"--devices-per-host = {topology.n_proc}")
        args.devices = topology.n_proc

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
    from repro_torch.obs import JsonlLogger, SpanTracer
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
            trace_period=args.trace_period,
            trace_cap=args.trace_cap,
            ckpt_period=args.ckpt_period,
            topology=topology,
            # stack_cap=None: sized by RuntimeConfig.resolve for the
            # dataset's bucket and the miner count
            stack_cap=args.stack_cap or None,
        ),
        tracer=SpanTracer(torch_profiler=bool(args.profile_out)),
    )
    if args.query == "closed-frequent":
        query = ClosedFrequentQuery(min_sup=args.min_sup)
    elif args.query == "topk":
        query = TopKSignificantQuery(k=args.k, statistic=args.stat)
    else:
        query = SignificantPatternQuery(
            alpha=args.alpha, statistic=args.stat, pipeline=args.pipeline
        )
    prof = _profiler(session.device) if args.profile_out else None
    t0 = time.time()
    with prof or contextlib.nullcontext():
        report = session.run(ds, query,
                             ckpt_dir=args.ckpt_dir or None,
                             resume_from=args.resume or None)
        if prof is not None and session.device.type == "cuda":
            import torch

            torch.cuda.synchronize(session.device)   # the last kernels in
    dt = time.time() - t0
    if any(p.resumed for p in report.phases):
        resumed = [p.mode for p in report.phases if p.resumed]
        print(f"[ckpt] resumed phase(s) {resumed} from {args.resume}",
              file=sys.stderr)
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
    if args.ckpt_period:
        out["ckpt"] = {
            "partial": report.partial,
            "resumed": [p.mode for p in report.phases if p.resumed],
            "writes": sum(p.ckpt_writes for p in report.phases),
            "bytes": sum(p.ckpt_bytes for p in report.phases),
            "path": report.ckpt_path,
        }
    if report.query == "significant":
        out["planted_recall"] = score_planted(rs, ds.planted)["recall"]
    if args.trace_period:
        # the work phase's decoded device timeline, as load-balance metrics
        wp = (report.phases[1] if report.query == "significant"
              and len(report.phases) > 1 else report.phases[-1])
        if wp.trace is not None:
            out["superstep_trace"] = wp.trace.summary()
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
    if prof is not None:
        prof.export_chrome_trace(args.profile_out)
        print(f"[out] wrote the profile with the session's spans to "
              f"{args.profile_out} (open in ui.perfetto.dev)")


def _profiler(device):
    """A `torch.profiler.profile` of the host, and of the card when the
    session runs on one."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


if __name__ == "__main__":
    sys.exit(main())
