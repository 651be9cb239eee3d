"""Named per-miner engine counters (the `stats` vector in the BSP carry).

A copy of `repro.core.stats`.

Every phase module indexes the shared `stats [len(Stat)]i32` array through
`Stat.*` members — never through magic integers — so a carry-layout change
cannot silently misattribute a counter.  `STAT_NAMES` (the key order of
`MineOutput.stats`) is derived from the enum, keeping the device vector and
the host dict in lockstep by construction.
"""

from __future__ import annotations

import enum

__all__ = ["Stat", "STAT_NAMES"]


class Stat(enum.IntEnum):
    """Index of each counter in the per-miner stats vector."""

    POPPED = 0         # nodes popped alive (sup >= lambda) by EXPAND
    REJECTED = 1       # alive pops failing the deferred-PPC check
    CLOSED = 2         # closed sets counted into the histogram
    PUSHED = 3         # children pushed
    STEALS_GOT = 4     # steal replies received with nodes
    GIVES = 5          # donations made
    IDLE_STEPS = 6     # supersteps ended with an empty stack
    SUPERSTEPS = 7     # superstep count (per miner; all equal)
    OVERFLOW = 8       # stack/push-cap overflow events (fatal in postprocess)
    STOLEN_NODES = 9   # total nodes donated
    EMIT_DROPPED = 10  # pattern records lost to out_cap saturation
    STEAL_ROUNDS = 11  # hunger-gated exchange rounds actually executed
    TRACE_DROPPED = 12  # sampled trace records lost to ring saturation


STAT_NAMES = tuple(s.name.lower() for s in Stat)
