"""Device superstep trace — record layout and host-side decode (a copy of
`repro.obs.trace`; DESIGN.md §9).

The paper's headline claim is *evenly distributed communication*: global
load balancing over hypercube lifelines is what buys the speedup.  This
module makes that claim measurable.  The engine threads a fixed-size
``[trace_cap, N_FIELDS] i32`` ring buffer through the BSP carry and, every
``trace_period`` supersteps, writes one record per miner — the lambda in
force, the live stack depth, the hunger census, whether the steal exchange
fired, and the superstep's pop/push/close/emit/donate/receive volumes.
Recording is **psum-free**: every field is a value the superstep already
holds (the census psum runs regardless), so tracing adds one ``[N_FIELDS]``
scatter per sampled step and nothing to the collective footprint.

``trace_period == 0`` (the default) compiles the trace out entirely; the
period is part of ``EngineConfig`` and therefore of the session's compiled-
program cache key.  When the ring wraps, older records are overwritten and
the overwrite count lands in the ``trace_dropped`` engine stat so the host
can warn (mirroring ``emit_dropped`` — telemetry loss is never silent).

`decode_trace` turns the raw per-miner rings into a `SuperstepTrace`: field
arrays ordered by superstep id (the surviving window after any wrap), plus
the load-balance metrics the ROADMAP's multi-host work will be debugged
with — per-miner idle fractions, max/mean stack depth, and Jain's fairness
index over donation volumes (1.0 = perfectly even steal traffic, 1/P =
one miner does all the donating).

This module is pure numpy + stdlib so the engine can import the field
layout without a dependency cycle (core -> obs only).  In the port the
ring is a [P, trace_cap, N_FIELDS] int32 tensor on the device and the
superstep counter is a host int, so only sampled supersteps write a record.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

__all__ = [
    "DEFAULT_TRACE_CAP",
    "N_FIELDS",
    "SuperstepTrace",
    "TraceField",
    "decode_trace",
    "jain_fairness",
]

#: ring size RuntimeConfig.resolve supplies when tracing is on but no
#: explicit trace_cap was given (4096 sampled steps outlasts every
#: committed benchmark problem at trace_period=1)
DEFAULT_TRACE_CAP = 4096


class TraceField(enum.IntEnum):
    """Column of each per-superstep trace record ([N_FIELDS] i32 per miner).

    STEP/LAMBDA/HUNGRY/FIRED are replicated across miners (they derive from
    psum results every miner holds); the rest are genuinely per-miner.
    """

    STEP = 0       # superstep id t (monotone; the decode sort key)
    LAMBDA = 1     # lambda in force during this superstep (pre-sync)
    DEPTH = 2      # live stack depth after EXPAND + STEAL (sp entering t+1)
    HUNGRY = 3     # n_hungry: miners with empty stacks after EXPAND (global)
    FIRED = 4      # 1 iff the gated steal exchange ran this superstep
    POPPED = 5     # nodes popped alive by EXPAND this superstep
    PUSHED = 6     # children pushed this superstep
    CLOSED = 7     # closed sets counted into the histogram this superstep
    EMITTED = 8    # pattern records emitted this superstep
    DONATED = 9    # nodes this miner donated in this round's GIVE
    RECEIVED = 10  # nodes this miner received in this round's reply


N_FIELDS = len(TraceField)


def jain_fairness(x) -> float:
    """Jain's fairness index (sum x)^2 / (n * sum x^2), in [1/n, 1].

    1.0 = perfectly even shares, 1/n = one participant holds everything.
    The all-zero vector (nothing to share) is defined as perfectly fair.
    """
    x = np.asarray(x, dtype=np.float64)
    if x.size == 0:
        return 1.0
    sq = float(np.sum(x * x))
    if sq == 0.0:
        return 1.0
    return float(np.sum(x)) ** 2 / (x.size * sq)


@dataclass(frozen=True)
class SuperstepTrace:
    """Decoded per-miner superstep timeline + load-balance metrics.

    Scalar series (`steps`, `lam`, `n_hungry`, `fired`) are [S]; per-miner
    series are [P, S].  S = min(sampled steps, trace_cap): after a ring
    wrap only the most recent window survives and `dropped` counts the
    overwritten records.
    """

    period: int            # sampling period (supersteps between records)
    cap: int               # ring capacity the engine ran with
    dropped: int           # sampled records overwritten by ring wrap
    steps: np.ndarray      # [S] superstep ids, strictly increasing
    lam: np.ndarray        # [S] lambda in force per sampled step
    n_hungry: np.ndarray   # [S] global hunger census per sampled step
    fired: np.ndarray      # [S] 1 iff the steal exchange ran
    depth: np.ndarray      # [P, S] live stack depth per miner
    popped: np.ndarray     # [P, S] nodes popped alive per miner
    pushed: np.ndarray     # [P, S] children pushed per miner
    closed: np.ndarray     # [P, S] closed sets counted per miner
    emitted: np.ndarray    # [P, S] pattern records emitted per miner
    donated: np.ndarray    # [P, S] per-round donation volume per miner
    received: np.ndarray   # [P, S] per-round received volume per miner
    # the lifeline schedule the engine cycled (LifelineSchedule.names /
    # .tiers), when the decoder was given it: superstep t ran round
    # t % len(schedule_names), which keys the per-round steal attribution
    # below.  None = schedule unknown (legacy decode) — per-round methods
    # then return empty/flat aggregates.
    schedule_names: tuple | None = None
    schedule_tiers: tuple | None = None  # "local" | "cross" | "flat" per round

    @property
    def n_miners(self) -> int:
        return int(self.depth.shape[0])

    @property
    def n_steps(self) -> int:
        return int(self.steps.shape[0])

    # ------------------------------------------------------------- metrics
    def idle_fraction(self) -> np.ndarray:
        """[P] fraction of sampled supersteps each miner popped zero nodes."""
        if self.n_steps == 0:
            return np.zeros(self.n_miners)
        return (self.popped == 0).mean(axis=1)

    def donation_fairness(self) -> float:
        """Jain's index over per-miner total donated nodes — the paper's
        "evenly distributed communication", as one number in [1/P, 1]."""
        return jain_fairness(self.donated.sum(axis=1))

    def work_fairness(self) -> float:
        """Jain's index over per-miner total popped nodes (load balance)."""
        return jain_fairness(self.popped.sum(axis=1))

    def _round_of_step(self) -> np.ndarray | None:
        """[S] schedule-round index of each sampled superstep, or None."""
        if self.schedule_names is None or self.n_steps == 0:
            return None
        return np.asarray(self.steps) % len(self.schedule_names)

    def steal_by_round(self) -> dict:
        """Per-schedule-round steal attribution, keyed by round name.

        Each value: {tier, steps, fired, donated, received} summed over the
        sampled window (all miners).  The multi-host question this answers:
        how much steal volume moved on cheap intra-host rounds vs expensive
        cross-host ones.  Empty when the decoder wasn't given the schedule.
        """
        rounds = self._round_of_step()
        if rounds is None:
            return {}
        names = self.schedule_names
        tiers = self.schedule_tiers or ("flat",) * len(names)
        out: dict = {}
        for r, name in enumerate(names):
            mask = rounds == r
            agg = out.setdefault(name, {
                "tier": tiers[r], "steps": 0, "fired": 0,
                "donated": 0, "received": 0,
            })
            agg["steps"] += int(mask.sum())
            agg["fired"] += int(self.fired[mask].sum())
            agg["donated"] += int(self.donated[:, mask].sum())
            agg["received"] += int(self.received[:, mask].sum())
        return out

    def tier_fairness(self) -> dict:
        """Jain's donation fairness split by schedule tier.

        {tier: index in [1/P, 1]} over per-miner donated volumes restricted
        to that tier's rounds — the paper's "evenly distributed
        communication" claim, now answerable separately for the intra-host
        and cross-host planes.  {} when the schedule is unknown.
        """
        rounds = self._round_of_step()
        if rounds is None:
            return {}
        tiers = self.schedule_tiers or ("flat",) * len(self.schedule_names)
        out = {}
        for tier in dict.fromkeys(tiers):  # stable unique order
            round_ids = [r for r, t in enumerate(tiers) if t == tier]
            mask = np.isin(rounds, round_ids)
            out[tier] = jain_fairness(self.donated[:, mask].sum(axis=1))
        return out

    def depth_imbalance(self) -> float:
        """Mean over sampled steps of max/mean live stack depth across
        miners (steps where every stack is empty contribute 1.0)."""
        if self.n_steps == 0:
            return 1.0
        d = self.depth.astype(np.float64)
        mean = d.mean(axis=0)
        ratio = np.where(mean > 0, d.max(axis=0) / np.maximum(mean, 1e-300), 1.0)
        return float(ratio.mean())

    def summary(self) -> dict:
        """JSON-able metrics blob (benchmarks, --verbose run records)."""
        donated_tot = self.donated.sum(axis=1)
        out = {
            "sampled_steps": self.n_steps,
            "period": self.period,
            "dropped": self.dropped,
            "steal_rounds_fired": int(self.fired.sum()),
            "fired_fraction": round(float(self.fired.mean()), 4)
            if self.n_steps else 0.0,
            "donation_fairness": round(self.donation_fairness(), 4),
            "work_fairness": round(self.work_fairness(), 4),
            "depth_imbalance": round(self.depth_imbalance(), 3),
            "idle_fraction": [round(float(x), 4) for x in self.idle_fraction()],
            "donated_nodes": [int(x) for x in donated_tot],
            "depth_mean": [round(float(x), 1) for x in
                           self.depth.mean(axis=1)] if self.n_steps else [],
            "depth_max": [int(x) for x in self.depth.max(axis=1)]
            if self.n_steps else [],
        }
        if self.schedule_names is not None:
            out["steal_by_round"] = self.steal_by_round()
            out["tier_fairness"] = {
                k: round(v, 4) for k, v in self.tier_fairness().items()
            }
        return out


def expected_samples(supersteps: int, period: int) -> int:
    """Records a `supersteps`-long run writes: steps 0, p, 2p, ... < T."""
    if period <= 0 or supersteps <= 0:
        return 0
    return (supersteps - 1) // period + 1


def decode_trace(
    raw: np.ndarray, *, supersteps: int, period: int,
    round_names: tuple | None = None, round_tiers: tuple | None = None,
) -> SuperstepTrace:
    """Raw device rings [P, cap, N_FIELDS] -> decoded `SuperstepTrace`.

    The engine writes sample idx = t // period into slot idx % cap, so
    after a wrap the ring holds the *last* cap samples with the oldest at
    slot (n_sampled % cap); ordering by the recorded STEP field recovers
    the window.  All miners sample the same steps (t is replicated), so
    miner 0's STEP column orders every miner's ring identically.

    `round_names`/`round_tiers` (LifelineSchedule.names / .tiers) attribute
    each sampled step to its steal round (t mod n_rounds), enabling the
    per-round and per-tier steal aggregations on the decoded trace.
    """
    raw = np.asarray(raw)
    if raw.ndim != 3 or raw.shape[2] != N_FIELDS:
        raise ValueError(
            f"expected raw trace [P, cap, {N_FIELDS}], got {raw.shape}"
        )
    cap = raw.shape[1]
    n_sampled = expected_samples(supersteps, period)
    valid = min(n_sampled, cap)
    dropped = n_sampled - valid
    window = raw[:, :valid, :]
    order = np.argsort(window[0, :, TraceField.STEP], kind="stable")
    window = window[:, order, :]

    def scalar(f):
        return window[0, :, f].copy()

    def per_miner(f):
        return window[:, :, f].copy()

    return SuperstepTrace(
        period=period,
        cap=cap,
        dropped=dropped,
        steps=scalar(TraceField.STEP),
        lam=scalar(TraceField.LAMBDA),
        n_hungry=scalar(TraceField.HUNGRY),
        fired=scalar(TraceField.FIRED),
        depth=per_miner(TraceField.DEPTH),
        popped=per_miner(TraceField.POPPED),
        pushed=per_miner(TraceField.PUSHED),
        closed=per_miner(TraceField.CLOSED),
        emitted=per_miner(TraceField.EMITTED),
        donated=per_miner(TraceField.DONATED),
        received=per_miner(TraceField.RECEIVED),
        schedule_names=tuple(round_names) if round_names is not None else None,
        schedule_tiers=tuple(round_tiers) if round_tiers is not None else None,
    )
