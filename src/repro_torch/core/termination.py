"""Distributed termination detection (paper §4.3) — Mattern's time algorithm
(a copy of `repro.core.termination`, host only).

Inside one BSP superstep loop, termination is exact: a global census of
empty stacks at a superstep boundary implies no work and no in-flight
messages (the collectives complete before the check; core/engine.py, and
core/collectives.py across processes).  That removes the race Mattern's
algorithm exists to fix — *within* one program.

Across independent programs the control plane is asynchronous again:
controllers exchange work-summary and steal messages over a slow network
with real in-flight time.  There we use the paper's choice — Mattern's
bounded clock-counter ("time") algorithm on a spanning tree (the paper uses a
ternary tree; so do we).

Each process keeps a logical clock `t`, a message counter `c` (sends minus
receives of *basic* messages), and stamps every basic message with its send
time.  A wave (initiated by the root, propagated down the ternary tree and
accumulated back up) collects (max_clock, sum_counters, any_stale_receive).
The wave at clock T declares termination iff the summed counter is zero AND
no process received a basic message stamped from a *past* wave epoch after
reporting — the "messages crossing the past/future boundary" test.

This module is transport-agnostic: `TerminationDetector` is driven by its
controller via callbacks, and the simulated-transport unit tests exercise the
classic false-termination races (message in flight during the wave).
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["TerminationDetector", "TernaryTree"]


class TernaryTree:
    """Spanning tree with fan-out 3 over process ids 0..P-1 (paper §4.3)."""

    def __init__(self, n_proc: int, fanout: int = 3):
        self.n = n_proc
        self.fanout = fanout

    def parent(self, i: int) -> int | None:
        return None if i == 0 else (i - 1) // self.fanout

    def children(self, i: int) -> list[int]:
        lo = i * self.fanout + 1
        return [c for c in range(lo, lo + self.fanout) if c < self.n]


@dataclass
class _WaveAccum:
    max_clock: int = 0
    counter_sum: int = 0
    stale: bool = False
    pending: int = 0  # children yet to report


class TerminationDetector:
    """Mattern bounded clock-counter algorithm for one process.

    Basic-message hooks:
      on_basic_send()            -> returns the timestamp to attach
      on_basic_receive(stamp)    -> call with the sender's stamp

    Control wave (host side): the root calls start_wave(); control messages
    are returned as (dst, payload) tuples from the handlers and must be
    delivered by the transport; handle_control() processes them.  When a wave
    completes at the root, `terminated` is set if it detected global quiet.
    """

    WAVE_DOWN = "wave_down"
    WAVE_UP = "wave_up"

    def __init__(self, rank: int, tree: TernaryTree, is_idle=lambda: True):
        self.rank = rank
        self.tree = tree
        self.is_idle = is_idle
        self.clock = 0  # logical time = number of waves seen
        self.counter = 0  # basic sends - receives
        self.stale_since_report = False
        self.terminated = False
        self._acc: _WaveAccum | None = None

    # ---- basic message instrumentation (paper: every payload carries a stamp)
    def on_basic_send(self) -> int:
        self.counter += 1
        return self.clock

    def on_basic_receive(self, stamp: int) -> None:
        self.counter -= 1
        # a message stamped before my current epoch crossed the wave boundary
        if stamp < self.clock:
            self.stale_since_report = True

    # ---- control wave
    def start_wave(self):
        assert self.rank == 0, "only the root initiates waves"
        self.clock += 1
        return self._begin_wave(self.clock)

    def _begin_wave(self, wave_clock: int):
        self.clock = max(self.clock, wave_clock)
        self._acc = _WaveAccum(pending=len(self.tree.children(self.rank)))
        out = [
            (c, (self.WAVE_DOWN, wave_clock)) for c in self.tree.children(self.rank)
        ]
        if self._acc.pending == 0:
            out += self._report_up()
        return out

    def _report_up(self):
        acc = self._acc
        assert acc is not None
        acc.max_clock = max(acc.max_clock, self.clock)
        acc.counter_sum += self.counter
        acc.stale = acc.stale or self.stale_since_report or not self.is_idle()
        self.stale_since_report = False
        self._acc = None
        parent = self.tree.parent(self.rank)
        if parent is None:
            # root: wave complete — Mattern's test
            if acc.counter_sum == 0 and not acc.stale:
                self.terminated = True
            return []
        return [(parent, (self.WAVE_UP, (acc.max_clock, acc.counter_sum, acc.stale)))]

    def handle_control(self, payload):
        kind, data = payload
        if kind == self.WAVE_DOWN:
            return self._begin_wave(data)
        if kind == self.WAVE_UP:
            max_clock, counter_sum, stale = data
            acc = self._acc
            assert acc is not None and acc.pending > 0
            acc.max_clock = max(acc.max_clock, max_clock)
            acc.counter_sum += counter_sum
            acc.stale = acc.stale or stale
            acc.pending -= 1
            if acc.pending == 0:
                return self._report_up()
            return []
        raise ValueError(kind)
