"""Typed mining reports — the session's answer objects (counterpart of
`repro.api.report`).

`PhaseReport` wraps one engine pass (which program ran, whether it was a
warm cache hit, wall/build time, and the raw `MineOutput`); `MineReport` is
the full query answer: the LAMP quantities, the `ResultSet` of mined
patterns, and per-phase reports.  `to_legacy_dict()` gives the JAX
package's documented `lamp_distributed` dict.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.core.engine import MineOutput
from repro_torch.obs.trace import SuperstepTrace
from repro_torch.results import ResultSet

__all__ = ["PhaseReport", "MineReport"]


@dataclass(frozen=True)
class PhaseReport:
    """One engine pass: what ran, how long, and its raw output."""

    mode: str                  # "lamp1" | "count" | "test" | "count2d"
    wall_s: float              # end-to-end phase wall time (incl. build)
    compile_s: float           # program build time (0.0 on a warm hit)
    cache_hit: bool            # True = reused an already-built program
    supersteps: int
    lam_final: int
    n_nodes: int               # total nodes popped across miners
    steals: int                # total steal receptions across miners
    steal_rounds: int          # hunger-gated exchange rounds that executed
    emit_dropped: int          # pattern records lost to out_cap saturation
    output: MineOutput = field(repr=False)  # full raw telemetry
    # kernel provenance — the *resolved* support-count dispatch this pass
    # ran with:
    kernel_impl: str = "ref"   # "ref" | "cuda" (never "auto")
    #: the CUDA kernel's (block_b, block_m, block_w) tile of the superstep's
    #: support count; None for the plain version
    kernel_blocks: "tuple[int, int, int] | None" = None
    item_tile: int = 0         # tile width of the db layout (0 = untiled)
    n_item_tiles: int = 1      # tiles per support-count sweep
    # decoded device superstep timeline (DESIGN.md §9); present iff the
    # session ran with trace_period > 0:
    trace: SuperstepTrace | None = field(default=None, repr=False)
    trace_dropped: int = 0     # sampled trace records lost to ring wrap
    # per-schedule-round steal attribution (traced sessions only): round
    # name -> {tier, steps, fired, donated, received}, and Jain's donation
    # fairness by steal tier ("flat" on the one-level schedule)
    steal_by_round: dict | None = field(default=None, repr=False)
    tier_fairness: dict | None = None
    # fault-tolerance provenance (DESIGN.md §11; segmented runs only):
    partial: bool = False      # stopped cooperatively at a segment boundary
    resumed: bool = False      # frontier restored from a checkpoint
    ckpt_writes: int = 0       # frontier checkpoints written this phase
    ckpt_bytes: int = 0        # total frontier payload bytes written
    ckpt_path: str | None = None  # newest published step dir (None = none)

    @property
    def stats(self):
        """Per-miner counter arrays (STAT_NAMES keyed)."""
        return self.output.stats


@dataclass(frozen=True)
class MineReport:
    """The answer to one mining query.

    Significant-pattern queries fill every field; other objectives leave
    the LAMP quantities that don't apply to them as NaN (alpha/delta) or
    their trivial values, and tag themselves via `query`/`statistic`.
    """

    dataset: str               # Dataset.name
    pipeline: str              # "three_phase" | "fused23" | objective tag
    alpha: float               # NaN for alpha-free objectives
    lambda_final: int
    min_sup: int
    correction_factor: int     # k: number of testable (closed) patterns
    delta: float               # alpha / k, the corrected level (NaN if unused)
    n_significant: int
    results: ResultSet         # the mined patterns themselves
    phases: tuple[PhaseReport, ...]
    wall_s: float              # full query wall time
    statistic: str | None = "fisher"  # repro_torch.stats key; None = untested
    query: str = "significant"        # objective tag (api.query.QUERIES key)
    #: True when the query stopped at a soft deadline before completing —
    #: `results` covers only the explored region (results.complete is
    #: False) and `ckpt_path` names the frontier checkpoint to resume from
    partial: bool = False
    ckpt_path: str | None = None

    @property
    def cold(self) -> bool:
        """True when any phase had to build its program."""
        return any(not p.cache_hit for p in self.phases)

    @property
    def kernel_impl(self) -> str:
        """Resolved support-count kernel that carried the expand path (all
        phases of one query resolve identically)."""
        return self.phases[0].kernel_impl if self.phases else "ref"

    @property
    def kernel_blocks(self) -> "tuple[int, int, int] | None":
        return self.phases[0].kernel_blocks if self.phases else None

    @property
    def item_tile(self) -> int:
        return self.phases[0].item_tile if self.phases else 0

    def summary(self) -> str:
        tag = "cold" if self.cold else "warm"
        if self.query == "closed-frequent":
            head = (f"{self.dataset}[closed-frequent] min_sup={self.min_sup} "
                    f"closed={self.n_significant}")
        else:
            stat = f" stat={self.statistic}" if self.statistic != "fisher" else ""
            delta = "n/a" if math.isnan(self.delta) else f"{self.delta:.3e}"
            head = (
                f"{self.dataset}[{self.pipeline}]{stat} "
                f"lambda={self.lambda_final} min_sup={self.min_sup} "
                f"k={self.correction_factor} delta={delta} "
                f"significant={self.n_significant}"
            )
        return f"{head} ({self.wall_s:.3f}s {tag})"

    def to_legacy_dict(self) -> dict:
        """The JAX package's documented `lamp_distributed` dict."""
        return {
            "lambda_final": self.lambda_final,
            "min_sup": self.min_sup,
            "correction_factor": self.correction_factor,
            "delta": self.delta,
            "n_significant": self.n_significant,
            "results": self.results,
            "phase_outputs": tuple(p.output for p in self.phases),
        }
