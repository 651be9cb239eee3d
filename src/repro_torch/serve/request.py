"""Request lifecycle types of the serving layer (counterpart of
`repro.serve.request`; DESIGN.md §10).

A `ServeRequest` is one admitted query riding the scheduler queue: it
carries the (dataset, query) pair, the client tag, an optional absolute
deadline, an optional `ResultStream` for top-k-first delivery, and an
`asyncio.Future` that resolves to a `ServeResult`.  Its tiny state machine

    queued -> running -> ok | error
    queued -> timeout | cancelled            (never started)

is guarded by a `threading.Lock` because the two sides race by design: the
deadline timer and `cancel()` fire on the event-loop thread while
`try_start()` fires on a fleet worker thread.  Whichever transition wins
owns the future's resolution (always completed via
`loop.call_soon_threadsafe`, so consumers only ever see it resolve on the
loop thread).

Fault tolerance (DESIGN.md §11) adds two non-terminal arcs: a worker
failure may send running -> queued again (`reset_for_retry`, attempt count
incremented — the scheduler's retry budget decides), and a soft deadline
may end a running request with outcome "partial": a real, truncated
`MineReport` (results.complete == False) plus the frontier checkpoint path
instead of a bare timeout.

Requests that the scheduler refuses to enqueue never become `ServeRequest`s
at all — admission control raises `AdmissionError(reason)` at `submit()`.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Any

__all__ = [
    "AdmissionError",
    "ServeRequest",
    "ServeResult",
]

#: terminal outcomes a request can resolve with (ServeResult.outcome) —
#: "rejected" never appears in a future (admission raises instead) but is
#: the label admission rejections count under in the metrics surface;
#: "partial" is a soft-deadline stop carrying a truncated report (§11)
OUTCOMES = ("ok", "partial", "timeout", "cancelled", "error", "rejected")

_ids = itertools.count()


class AdmissionError(RuntimeError):
    """The scheduler refused to enqueue a request; `.reason` says why
    ("queue_full" | "shutting_down")."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(detail or reason)


@dataclass(frozen=True)
class ServeResult:
    """The answer to one served request (what the request future resolves to).

    `ok` requests carry the full `MineReport`; failed ones carry the
    outcome + reason.  Timing splits the request's life into time-in-queue
    and service time so tail-latency regressions are attributable.
    """

    outcome: str                  # "ok" | "partial" | "timeout" | "cancelled" | "error"
    report: Any = None            # repro_torch.api.MineReport (outcome "ok"/"partial")
    reason: str | None = None     # human-readable failure detail
    queued_s: float = 0.0         # admission -> start (or terminal, if never run)
    service_s: float = 0.0        # engine + result-build wall time
    total_s: float = 0.0          # admission -> resolution
    session_id: int | None = None  # fleet worker that served it
    batch_size: int = 1           # size of the coalesced batch it rode
    batch_index: int = 0          # its position within that batch
    attempts: int = 1             # serve attempts consumed (retries + 1)
    ckpt_path: str | None = None  # frontier checkpoint (outcome "partial")

    @property
    def ok(self) -> bool:
        return self.outcome == "ok"


class ServeRequest:
    """One admitted request: payload + deadline + state machine + future."""

    __slots__ = (
        "rid", "dataset", "query", "client", "stream", "signature",
        "deadline", "submitted", "started", "future", "timer", "attempts",
        "_state", "_lock",
    )

    def __init__(self, dataset, query, *, client: str = "", stream=None,
                 signature=None, timeout_s: float | None = None, loop=None):
        self.rid = next(_ids)
        self.dataset = dataset
        self.query = query
        self.client = client
        self.stream = stream
        # batching identity: requests with equal signatures share warm
        # programs and may coalesce onto one session (serve.batch)
        self.signature = signature
        self.submitted = time.perf_counter()
        self.started: float | None = None
        self.deadline = (self.submitted + timeout_s
                         if timeout_s is not None else None)
        self.future = loop.create_future()
        self.timer = None          # loop.call_later handle (scheduler-owned)
        self.attempts = 1          # serve attempts, counting the current one
        self._state = "queued"
        self._lock = threading.Lock()

    # ------------------------------------------------------------ state
    @property
    def state(self) -> str:
        return self._state

    def try_start(self) -> bool:
        """queued -> running (worker thread); False if a terminal transition
        (timeout/cancel) won the race or the deadline has already passed."""
        with self._lock:
            if self._state != "queued":
                return False
            if self.deadline is not None and time.perf_counter() > self.deadline:
                return False       # caller resolves it as a timeout
            self._state = "running"
            self.started = time.perf_counter()
            return True

    def try_terminate(self, state: str) -> bool:
        """queued -> timeout|cancelled (loop thread); False if started."""
        with self._lock:
            if self._state != "queued":
                return False
            self._state = state
            return True

    def try_terminate_running(self, state: str) -> bool:
        """running -> error (loop thread; batch-runner death cleanup)."""
        with self._lock:
            if self._state != "running":
                return False
            self._state = state
            return True

    def reset_for_retry(self) -> bool:
        """running -> queued (worker thread, after a failed attempt).

        Bumps the attempt count; the deadline timer stays armed, so a
        retry that outlives its deadline still expires normally.  False if
        the request was not running (a terminal transition won).
        """
        with self._lock:
            if self._state != "running":
                return False
            self._state = "queued"
            self.started = None
            self.attempts += 1
            return True

    def finish(self, state: str) -> None:
        """running -> ok|partial|error (worker thread, post-engine)."""
        with self._lock:
            self._state = state

    # ----------------------------------------------------------- results
    def resolve(self, loop, result: ServeResult) -> None:
        """Complete the future from any thread (delivered on the loop)."""

        def _set():
            if self.timer is not None:
                self.timer.cancel()  # TimerHandle is loop-thread-only
                self.timer = None
            if not self.future.done():
                self.future.set_result(result)

        loop.call_soon_threadsafe(_set)

    def elapsed(self, now: float | None = None) -> float:
        return (now if now is not None else time.perf_counter()) - self.submitted
