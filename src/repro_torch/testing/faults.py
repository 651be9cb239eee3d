"""Deterministic fault injection for the fault-tolerance machinery (a copy
of `repro.testing.faults`, with the same fault points).

Production code calls `faults.check("<point>", **ctx)` at the places a real
deployment can die (the fault-point catalog, DESIGN.md §11):

  engine.superstep      host segment boundary, before the checkpoint write
                        (a kill here loses the running segment's progress)
  ckpt.pre_publish      checkpoint fully staged in the tmp dir, not yet
                        renamed in (a kill here must leave the previous
                        step intact and restorable)
  ckpt.published        checkpoint renamed into place (the corrupt-step
                        fault point flips bytes in the published payload
                        here, exercising checksum detection + fallback)
  serve.attempt         a fleet worker about to run one served request
                        (a death here must be retried, never dropped)

With no plan installed `check` is a near-free no-op, so the hooks cost
nothing in production.  A `FaultPlan` is installed process-globally
(`install`/`clear`, or the `injected` context manager); counters are
lock-guarded because serve faults fire on fleet worker threads.  Every
fault is deterministic — same plan, same sequence of `check` calls, same
failure — which is what lets the kill-and-resume tests assert bit-identical
recovery.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

__all__ = [
    "FaultPlan",
    "SimulatedFault",
    "check",
    "clear",
    "corrupt_step_dir",
    "injected",
    "install",
]


class SimulatedFault(RuntimeError):
    """An injected failure (never raised unless a FaultPlan is installed)."""

    def __init__(self, point: str, detail: str = ""):
        self.point = point
        super().__init__(f"simulated fault at {point}" +
                         (f": {detail}" if detail else ""))


@dataclass(frozen=True)
class FaultPlan:
    """What to break, deterministically.

    die_at_superstep      raise at the engine segment boundary whose
                          superstep counter t >= this value (-1 = never)
    die_after_segments    raise at the N-th engine segment boundary counted
                          globally across phases (-1 = never) — use this to
                          land a death in phase 2/3 of a staging, where the
                          per-phase t has reset
    die_in_ckpt_write     raise between staging a checkpoint and publishing
                          it (the crash-window test; -1 = never, else the
                          N-th write, 0-based)
    corrupt_after_step    after publishing step N, flip bytes in its
                          arrays.npz (checksum-detection test; -1 = never)
    serve_fail_first_n    fail the first N served attempts, globally across
                          workers (0 = never)
    seed                  byte-flip determinism for corrupt_step_dir
    """

    die_at_superstep: int = -1
    die_after_segments: int = -1
    die_in_ckpt_write: int = -1
    corrupt_after_step: int = -1
    serve_fail_first_n: int = 0
    seed: int = 0


_lock = threading.Lock()
_ACTIVE: FaultPlan | None = None
_counters: dict[str, int] = {}


def install(plan: FaultPlan) -> None:
    """Install `plan` process-globally (replacing any previous plan)."""
    global _ACTIVE
    with _lock:
        _ACTIVE = plan
        _counters.clear()


def clear() -> None:
    """Remove the active plan; `check` becomes a no-op again."""
    global _ACTIVE
    with _lock:
        _ACTIVE = None
        _counters.clear()


@contextlib.contextmanager
def injected(plan: FaultPlan):
    """`with injected(FaultPlan(...)):` — install for the block, then clear."""
    install(plan)
    try:
        yield plan
    finally:
        clear()


def _bump(key: str) -> int:
    """Increment and return the pre-increment value of a named counter."""
    with _lock:
        n = _counters.get(key, 0)
        _counters[key] = n + 1
        return n


def check(point: str, **ctx) -> None:
    """Raise SimulatedFault if the active plan targets this fault point."""
    plan = _ACTIVE
    if plan is None:
        return
    if point == "engine.superstep":
        seg = _bump("engine.superstep")
        t = int(ctx.get("t", -1))
        if plan.die_after_segments >= 0 and seg >= plan.die_after_segments:
            raise SimulatedFault(point, f"segment {seg} (t={t})")
        if plan.die_at_superstep >= 0 and t >= plan.die_at_superstep:
            raise SimulatedFault(point, f"t={t}")
    elif point == "ckpt.pre_publish":
        if plan.die_in_ckpt_write >= 0 and \
                _bump("ckpt.write") == plan.die_in_ckpt_write:
            raise SimulatedFault(point, f"step={ctx.get('step')}")
    elif point == "ckpt.published":
        if plan.corrupt_after_step >= 0 and \
                int(ctx.get("step", -1)) == plan.corrupt_after_step:
            corrupt_step_dir(str(ctx["path"]), plan.seed)
    elif point == "serve.attempt":
        if _bump("serve.attempt") < plan.serve_fail_first_n:
            raise SimulatedFault(
                point, f"rid={ctx.get('rid')} worker={ctx.get('worker')}")


def corrupt_step_dir(path: str, seed: int = 0) -> None:
    """Deterministically flip bytes in a published step dir's arrays.npz.

    Flips land in the back half of the file (the zip payload region for the
    uncompressed npz format), so the corruption models bit rot in array
    data rather than a torn directory — exactly what the per-leaf checksums
    exist to catch.
    """
    import os
    import random

    target = os.path.join(path, "arrays.npz")
    with open(target, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        rng = random.Random(seed)
        for _ in range(8):
            pos = rng.randrange(size // 2, size)
            f.seek(pos)
            byte = f.read(1)
            f.seek(pos)
            f.write(bytes([byte[0] ^ 0xFF]))
