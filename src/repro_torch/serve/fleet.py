"""The session fleet: warm MinerSessions behind the scheduler (counterpart
of `repro.serve.fleet`; DESIGN.md §10).

A fleet is N `MinerSession`s, each pinned to its own single-thread
executor — the sessions' one-query-at-a-time contract becomes a structural
property instead of a convention — plus the two policies that make repeat
traffic cheap:

  * **warmup**: at startup every worker pre-compiles the configured
    `WarmupSpec`s (shape bucket × statistic × staging) from placeholder
    datasets, so the first real query of a configured shape dispatches
    with zero compiles on *any* worker;
  * **residency + affinity**: each worker remembers the datasets it served
    (strong refs, LRU over a byte budget, so their packed device buffers
    stay alive) and `acquire` prefers an idle worker whose program cache
    is warm for the request's signature — and, among warm workers, one
    where the dataset's buffers are already resident.

One card, one stream per worker: `build` puts every session on the same
device (the JAX fleet's `devices` and `partition_devices`, which split a
TPU mesh into disjoint slices, have no counterpart on one card).  On CUDA
each worker owns a `torch.cuda.Stream`, and its thread runs every request,
warmup and rebuild inside `device_scope()` on that stream.  The engine
reads the hunger census back to the host once per superstep; on one shared
stream each such read would also wait for the other workers' queued work,
on its own stream it waits only for its own.  A request's scope first
makes the worker's stream wait for the default stream, where the client
packed and uploaded the dataset, and synchronises the worker's stream at
its end, so no kernel still reads a dataset's buffers once its request
resolved.  On the CPU a worker has no stream.
"""

from __future__ import annotations

import asyncio
import contextlib
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import torch

from repro_torch.api.dataset import Dataset, ShapeBucket

__all__ = ["FleetWorker", "SessionFleet", "WarmupSpec"]


@dataclass(frozen=True)
class WarmupSpec:
    """One startup pre-compile target: a shape bucket under a statistic.

    `statistic=None` warms the statistic-free programs (closed-frequent
    traffic); `pipeline=None` uses the session's configured staging.
    """

    bucket: ShapeBucket
    statistic: str | None = "fisher"
    pipeline: str | None = None
    alpha: float | None = None


class FleetWorker:
    """One warm session + its confinement thread + its CUDA stream + its
    resident datasets.

    Circuit breaker (DESIGN.md §11): consecutive failed attempts trip
    `broken` at `breaker_threshold`, ejecting the worker from `acquire`
    until the scheduler rebuilds its session (`SessionFleet.rebuild_worker`
    + `note_repaired`); any success resets the count.
    """

    def __init__(self, wid: int, session, *, residency_budget_bytes: int,
                 session_factory=None, breaker_threshold: int = 3):
        self.wid = wid
        self.session = session
        #: zero-arg callable rebuilding a fresh session on this worker's
        #: device; None = externally-owned sessions (rebuild resets the
        #: breaker but keeps the session)
        self.session_factory = session_factory
        #: the stream every request of this worker runs on (None off CUDA)
        device = getattr(session, "device", None)
        self.stream = (torch.cuda.Stream(device)
                       if isinstance(device, torch.device)
                       and device.type == "cuda" else None)
        self.executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"miner-{wid}"
        )
        self.busy = False
        self.served = 0
        self.failures = 0          # consecutive failed attempts
        self.broken = False        # breaker open: excluded from acquire
        self.rebuilding = False    # a rebuild task is in flight
        self.breaker_threshold = breaker_threshold
        self._budget = residency_budget_bytes
        # id(dataset) -> (dataset, nbytes); insertion order = LRU order.
        # Strong refs on purpose: residency means the packed buffers live.
        self._resident: OrderedDict[int, tuple[Dataset, int]] = OrderedDict()
        self._resident_bytes = 0

    # ------------------------------------------------------------- stream
    @contextlib.contextmanager
    def device_scope(self):
        """Run the body on this worker's stream (worker thread only).

        Entry makes the stream wait for the default stream (the client's
        uploads); exit synchronises it.  A no-op without a stream."""
        if self.stream is None:
            yield
            return
        self.stream.wait_stream(torch.cuda.default_stream(self.stream.device))
        try:
            with torch.cuda.stream(self.stream):
                yield
        finally:
            self.stream.synchronize()

    # ---------------------------------------------------------- residency
    @staticmethod
    def _nbytes(dataset: Dataset) -> int:
        """Bytes of the dataset's resident words ([m_pad, w_pad] int32:
        the JAX fleet's count of its [m_pad, w_pad] uint32 `db_bits`)."""
        packed = getattr(dataset, "packed", None)
        words = getattr(packed, "db_dev", None)
        return int(words.numel() * words.element_size()) if words is not None else 0

    def is_resident(self, dataset: Dataset) -> bool:
        return id(dataset) in self._resident

    @property
    def resident_bytes(self) -> int:
        return self._resident_bytes

    @property
    def n_resident(self) -> int:
        return len(self._resident)

    def note_served(self, dataset: Dataset) -> None:
        """Mark `dataset` most-recently-served; evict LRU over the budget.

        Called from this worker's own thread (run_batch) — each worker's
        residency map is confined to its thread plus the loop thread's
        read-only affinity scoring, where a stale read only mis-ranks."""
        key = id(dataset)
        if key in self._resident:
            self._resident.move_to_end(key)
            return
        nbytes = self._nbytes(dataset)
        self._resident[key] = (dataset, nbytes)
        self._resident_bytes += nbytes
        # keep at least the newest entry even when it alone busts the budget
        while self._resident_bytes > self._budget and len(self._resident) > 1:
            _, (_, dropped) = self._resident.popitem(last=False)
            self._resident_bytes -= dropped

    # ----------------------------------------------------------- affinity
    def score(self, signature, dataset: Dataset) -> tuple:
        """Dispatch preference: warm programs first, resident data second,
        then fewest-served for balance."""
        try:
            warm = 1 if signature.warm_on(self.session) else 0
        except ValueError:  # signature names a staging this build lacks
            warm = 0
        return (warm, 1 if self.is_resident(dataset) else 0, -self.served)

    # ----------------------------------------------------- circuit breaker
    def record_failure(self) -> None:
        """One failed attempt (worker thread).  Trips the breaker open at
        `breaker_threshold` consecutive failures."""
        self.failures += 1
        if self.failures >= self.breaker_threshold:
            self.broken = True

    def record_success(self) -> None:
        """One successful attempt (worker thread): closes the count."""
        self.failures = 0

    def shutdown(self) -> None:
        self.executor.shutdown(wait=True)


class SessionFleet:
    """N warm workers + the acquire/release gate the scheduler drives."""

    def __init__(self, sessions, *, warmups=(),
                 residency_budget_mb: float = 256.0):
        if not sessions:
            raise ValueError("SessionFleet needs at least one session")
        budget = int(residency_budget_mb * 1e6)
        self.workers = [
            FleetWorker(i, s, residency_budget_bytes=budget)
            for i, s in enumerate(sessions)
        ]
        self.warmups = tuple(warmups)
        self._idle_event = asyncio.Event()
        self._idle_event.set()

    # ------------------------------------------------------- construction
    @classmethod
    def build(cls, size: int, *, n_miners: int = 1, device=None,
              algorithm=None, runtime=None, metrics=None, warmups=(),
              residency_budget_mb: float = 256.0) -> "SessionFleet":
        """Build `size` sessions of `n_miners` virtual miners each, all on
        `device` (default: the card, as `MinerSession` resolves it).

        `metrics` is shared across all sessions (one scrape surface)."""
        from repro_torch.api.session import MinerSession

        if size < 1:
            raise ValueError(f"fleet size must be >= 1, got {size}")

        def make():
            return MinerSession(n_miners, device=device, algorithm=algorithm,
                                runtime=runtime, metrics=metrics)

        fleet = cls([make() for _ in range(size)], warmups=warmups,
                    residency_budget_mb=residency_budget_mb)
        # circuit-breaker recovery rebuilds on the same device with the same
        # miner count
        for worker in fleet.workers:
            worker.session_factory = make
        return fleet

    @property
    def size(self) -> int:
        return len(self.workers)

    # ------------------------------------------------------------- warmup
    async def start(self) -> int:
        """Run every warmup spec on every worker (on the workers' own
        threads, concurrently across workers).  Returns total programs
        compiled."""
        if not self.warmups:
            return 0
        loop = asyncio.get_running_loop()

        def _warm(worker: FleetWorker) -> int:
            n = 0
            with worker.device_scope():
                for spec in self.warmups:
                    n += worker.session.warmup(
                        spec.bucket, statistic=spec.statistic,
                        pipeline=spec.pipeline, alpha=spec.alpha,
                    )
            return n

        totals = await asyncio.gather(*[
            loop.run_in_executor(w.executor, _warm, w) for w in self.workers
        ])
        return sum(totals)

    # ---------------------------------------------------- acquire/release
    def acquire_nowait(self, signature, dataset) -> FleetWorker | None:
        """Claim the best-affinity idle worker, or None if all are busy.
        Loop-thread only."""
        idle = [w for w in self.workers if not w.busy and not w.broken]
        if not idle:
            return None
        best = max(idle, key=lambda w: w.score(signature, dataset))
        best.busy = True
        best.served += 1
        return best

    async def acquire(self, signature, dataset) -> FleetWorker:
        """Wait for an idle worker, then claim by affinity."""
        while True:
            worker = self.acquire_nowait(signature, dataset)
            if worker is not None:
                return worker
            self._idle_event.clear()
            await self._idle_event.wait()

    def release(self, worker: FleetWorker) -> None:
        worker.busy = False
        self._idle_event.set()

    # ------------------------------------------------------------- repair
    def rebuild_worker(self, worker: FleetWorker) -> None:
        """Replace a broken worker's session with a fresh one and re-warm it.

        MUST run on the worker's own executor thread (session confinement);
        the scheduler dispatches it there and calls `note_repaired` after.
        Without a `session_factory` (externally-owned sessions) the session
        is kept and only the failure count resets — a cool-off semantics.
        """
        if worker.session_factory is not None:
            with worker.device_scope():
                worker.session = worker.session_factory()
                for spec in self.warmups:
                    worker.session.warmup(
                        spec.bucket, statistic=spec.statistic,
                        pipeline=spec.pipeline, alpha=spec.alpha,
                    )
        worker.failures = 0

    def note_repaired(self, worker: FleetWorker) -> None:
        """Re-admit a rebuilt worker to `acquire` (loop thread)."""
        worker.broken = False
        worker.rebuilding = False
        self._idle_event.set()

    @property
    def n_busy(self) -> int:
        return sum(1 for w in self.workers if w.busy)

    async def shutdown(self) -> None:
        """Join every worker thread (after the scheduler drained them)."""
        loop = asyncio.get_running_loop()
        await asyncio.gather(*[
            loop.run_in_executor(None, w.shutdown) for w in self.workers
        ])
