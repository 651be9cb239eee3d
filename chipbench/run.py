#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `src/repro_torch` and
`BENCHMARK.json`, on a machine with the CUDA cards the cell asks for.  It
refuses to run without them (exit 2, no result), and never falls back to
the CPU.  The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` a `breakdown`,
and last the `checks` that decided `correct`, each number beside its
limit; the same checks are the last lines of standard error.

The kernel's build cache is `chipbench/out/build/` in the checkout, so only
a checkout's first run compiles.  After the window the process must hold
none of `jax`, `jaxlib`, `flax` or the JAX package `repro` (exit 3, no
result, if it does).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules the process may not hold (whole names: `repro_torch`
#: begins with `repro` and is the program)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _fail(msg: str, code: int) -> int:
    print(f"chipbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        return _fail(f"{ROOT / 'src' / 'repro_torch'} is missing: run from a checkout "
                     "of the repository", 2)
    # the kernel's nvcc output stays in the checkout, at a fixed path
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(HERE / "out" / "build")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))

    from chipbench.harness.spec import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is False: the benchmark runs on a "
                     "CUDA card only", 2)
    if torch.cuda.device_count() < cell.chips:
        return _fail(f"{args.workload} needs {cell.chips} cards, this machine has "
                     f"{torch.cuda.device_count()}", 2)

    from chipbench.harness.cell import run_cell

    result, checks = run_cell(cell, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), device="cuda", t_start=T_START)
    found = forbidden_modules()
    if found:
        return _fail(f"the process holds {found} after the window", 3)
    for name, v in checks.items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
