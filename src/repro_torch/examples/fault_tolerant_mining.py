"""Fault-tolerant mining: kill a run mid-flight, resume it elastically on
fewer miners, get the bit-identical answer (DESIGN.md §11).  The port's
counterpart of the JAX package's `examples/fault_tolerant_mining.py`.

  PYTHONPATH=src python -m repro_torch.examples.fault_tolerant_mining \
      [--miners 8] [--smoke] [--device cpu]

Demonstrates the checkpoint/resume path end to end:

  1. a baseline mine with all the miners (the reference answer);
  2. the same mine with periodic frontier checkpoints and an injected
     fault (`repro_torch.testing.faults`) that kills the engine a few
     segments in — what a preempted job looks like;
  3. an **elastic** resume of the killed run on HALF the miners: the saved
     frontier (cut at P miners) is re-dealt onto P/2 miners and mining
     continues from the checkpointed superstep;
  4. the proof: the resumed report's ResultSet — patterns, p-values,
     min_sup, correction factor — is identical to the uninterrupted
     baseline.  Work-stealing trajectories differ, answers never do.

It runs on the card by default; --device cpu runs it on the CPU.  --smoke
shrinks the problem to a few seconds.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--miners", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--scale-items", type=float, default=0.02)
    ap.add_argument("--ckpt-period", type=int, default=4,
                    help="supersteps between frontier checkpoints")
    ap.add_argument("--die-after", type=int, default=2,
                    help="checkpointed segments to survive before the "
                         "injected kill")
    ap.add_argument("--smoke", action="store_true",
                    help="a tiny problem and fast checkpoints")
    args = ap.parse_args(argv)
    if args.smoke:
        args.scale_items = min(args.scale_items, 0.01)

    from repro_torch.api import (
        Dataset,
        MinerSession,
        RuntimeConfig,
        SignificantPatternQuery,
    )
    from repro_torch.testing import FaultPlan, SimulatedFault, injected

    ds = Dataset.from_paper_problem("hapmap_dom_10", args.scale_items, 1.0,
                                    device=args.device)
    spec = ds.spec
    print(f"problem: {spec.name} scaled to {spec.n_items} items x "
          f"{spec.n_transactions} transactions")

    runtime = RuntimeConfig(expand_batch=8, ckpt_period=args.ckpt_period)
    query = SignificantPatternQuery(alpha=0.05)

    def session(n):
        return MinerSession(n, device=args.device, runtime=runtime)

    # 1. the uninterrupted reference answer with all the miners
    t0 = time.time()
    baseline = session(args.miners).run(ds, query)
    print(f"\nbaseline on {args.miners} miners in {time.time()-t0:.1f}s: "
          f"min_sup={baseline.min_sup} k={baseline.correction_factor} "
          f"significant={baseline.n_significant}")

    half = max(1, args.miners // 2)
    with tempfile.TemporaryDirectory(prefix="ft_mine_") as ckpt_dir:
        # 2. same mine, checkpointing every --ckpt-period supersteps, with
        #    a simulated death after --die-after completed segments
        try:
            with injected(FaultPlan(die_after_segments=args.die_after)):
                session(args.miners).run(ds, query, ckpt_dir=ckpt_dir)
            raise SystemExit("fault never fired — problem too small? "
                             "lower --ckpt-period")
        except SimulatedFault as exc:
            print(f"\ninjected kill: {exc}")
        saved = sorted(os.listdir(ckpt_dir))
        print(f"checkpoints on disk: {saved}")

        # 3. elastic resume on HALF the miners: the frontier saved at
        #    --miners miners is re-dealt onto the smaller set
        t0 = time.time()
        resumed = session(half).run(ds, query, resume_from=ckpt_dir)
        n_resumed = [p.mode for p in resumed.phases if p.resumed]
        print(f"\nresumed on {half} miners in {time.time()-t0:.1f}s "
              f"(phases restored from checkpoint: {n_resumed}): "
              f"min_sup={resumed.min_sup} k={resumed.correction_factor} "
              f"significant={resumed.n_significant}")

    # 4. bit-identical answers, different trajectories
    if baseline.results.to_json() != resumed.results.to_json():
        raise SystemExit("resumed ResultSet diverged from the baseline")
    if (baseline.min_sup, baseline.correction_factor, baseline.n_significant) != (
            resumed.min_sup, resumed.correction_factor, resumed.n_significant):
        raise SystemExit("resumed LAMP quantities diverged from the baseline")
    print(f"\nOK: {len(resumed.results)} patterns bit-identical across the "
          f"kill, the resume, and the {args.miners}->{half} reshard")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
