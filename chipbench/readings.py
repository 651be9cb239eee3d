#!/usr/bin/env python3
"""The two readings each check's limit is set from, for one cell.

    python3 chipbench/readings.py --workload <cell> --seeds 11,12,... \\
        --seconds <s> [--control-seeds 21,22,23] [--reseed]

For every seed of `--seeds`, one run of the cell's timed path on the card
(a window of `--seconds`, long enough to answer every distinct request of
the mix), judged against the reference: the lower readings.  For every
seed of `--control-seeds`, the control: the reference computed one
precision below what the configuration states (float32 P-values for a LAMP
query, bfloat16 supports for a closed-frequent one), put in the program's
place and judged the same way over every distinct request of the mix: the
upper readings.  With `--reseed` each seed also draws the datasets
themselves (generator seed = seed + the mix's own), instead of reordering
the transactions of the mix's fixed ones: other supports, other answers.
One JSON line per reading; the benchmark's runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def control_readings(cell, seed: int) -> dict:
    """The control's numbers for `seed` over every distinct request."""
    from chipbench.harness import data, judge
    from chipbench.harness.queries import reference_answer

    inputs = data.make_inputs(cell.config, cell.traffic, seed)
    n = len(cell.traffic["generator_seeds"]) * len(cell.traffic["params"])
    answers, reference = [], {}
    for d, q in data.distinct_requests(cell.traffic, n):
        x, params = inputs[d], cell.traffic["params"][q]
        db = x.dense()
        reference[(d, q)] = reference_answer(cell.config, db, x.labels, params)
        answers.append(((d, q), reference_answer(cell.config, db, x.labels, params,
                                                 control=True)))
    return judge.judge(answers, reference, 0, cell.config["checks"])


def reseeded(cell, seed: int):
    """`cell` with its mix's datasets drawn from `seed`."""
    traffic = dict(cell.traffic,
                   generator_seeds=[seed + int(g) for g in cell.traffic["generator_seeds"]])
    return dataclasses.replace(cell, traffic=traffic)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--reseed", action="store_true")
    args = ap.parse_args(argv)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(HERE / "out" / "build")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))

    from chipbench.harness.cell import run_cell
    from chipbench.harness.spec import load_cell

    cell = load_cell(args.workload)
    of = (lambda seed: reseeded(cell, seed)) if args.reseed else (lambda seed: cell)
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        result, checks = run_cell(of(seed), seed=seed, seconds=args.seconds, trace=False,
                                  device="cuda", t_start=time.perf_counter())
        print(json.dumps(dict(side="program", seed=seed, reseed=args.reseed,
                              correct=result["correct"], attempted=result["attempted"],
                              checks=checks)), flush=True)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        checks = control_readings(of(seed), seed)
        print(json.dumps(dict(side="control", seed=seed, reseed=args.reseed, checks=checks)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
