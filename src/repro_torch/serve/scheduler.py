"""The serving scheduler: admission, queueing, dispatch (counterpart of
`repro.serve.scheduler`; DESIGN.md §10).

One asyncio event loop owns a bounded FIFO request queue in front of the
session fleet:

  * **admission control** — `submit` raises `AdmissionError("queue_full")`
    the moment the queue is at capacity (callers see backpressure as a
    typed rejection, not unbounded latency) and
    `AdmissionError("shutting_down")` after `stop()`;
  * **deadlines** — a per-request timeout arms a loop timer; expiry while
    queued resolves the request as a timeout and removes it (it never
    touches a device), and `try_start`'s re-check catches deadlines that
    lapse between timer granularity and dispatch;
  * **cancellation** — `cancel(request)` terminates a *queued* request;
    running requests are not interruptible (BSP supersteps);
  * **dispatch** — the dispatcher awaits an idle worker chosen by warm-
    program/residency affinity for the queue head, coalesces the head's
    same-signature run (serve.batch) and drains it on the worker's thread,
    so the loop keeps admitting while miners mine;
  * **backpressure signal** — `backpressure` in [0, 1] is queue depth over
    capacity; it is also exported as a gauge so clients and load
    generators can shed before admission starts rejecting.

`MiningService` is the facade gluing one fleet + one scheduler + one
shared `MetricsRegistry` into the thing launchers and benchmarks start.
"""

from __future__ import annotations

import asyncio
import os
import random
from collections import deque
from dataclasses import dataclass

from repro_torch.obs import MetricsRegistry
from repro_torch.results import ResultStream

from .batch import collect_batch, program_signature, run_batch
from .fleet import SessionFleet
from .request import AdmissionError, ServeRequest, ServeResult

__all__ = ["MiningService", "Scheduler", "ServeConfig"]


@dataclass(frozen=True)
class ServeConfig:
    """Scheduler policy knobs."""

    queue_capacity: int = 64       # admission bound (requests, not batches)
    max_batch: int = 8             # same-signature coalescing bound
    default_timeout_s: float | None = None  # per-request deadline default
    # ---- fault tolerance (DESIGN.md §11) ----
    max_retries: int = 2           # extra attempts per request after the 1st
    retry_backoff_s: float = 0.05  # base requeue delay, doubles per retry
    retry_jitter: float = 0.25     # uniform backoff inflation, [0, jitter)
    breaker_threshold: int = 3     # consecutive failures ejecting a worker
    ckpt_root: str | None = None   # per-request frontier checkpoints go here

    def __post_init__(self):
        if self.queue_capacity < 1:
            raise ValueError(
                f"queue_capacity must be >= 1, got {self.queue_capacity}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.default_timeout_s is not None and self.default_timeout_s <= 0:
            raise ValueError(
                f"default_timeout_s must be positive, got "
                f"{self.default_timeout_s}")
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")
        if self.retry_backoff_s < 0 or self.retry_jitter < 0:
            raise ValueError(
                "retry_backoff_s and retry_jitter must be >= 0, got "
                f"{self.retry_backoff_s} / {self.retry_jitter}")
        if self.breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {self.breaker_threshold}")


class Scheduler:
    """Admission + bounded queue + affinity dispatch over one fleet."""

    def __init__(self, fleet: SessionFleet, config: ServeConfig | None = None,
                 *, metrics: MetricsRegistry | None = None):
        self.fleet = fleet
        self.config = config or ServeConfig()
        self.metrics = metrics or MetricsRegistry()
        m = self.metrics
        self._m_depth = m.gauge(
            "serve_queue_depth", "requests waiting for a session")
        self._m_pressure = m.gauge(
            "serve_backpressure", "queue depth over capacity, [0, 1]")
        self._m_requests = m.counter(
            "serve_requests_total", "served requests by terminal outcome",
            labels=("outcome",))
        self._m_rejected = m.counter(
            "serve_admission_rejections_total",
            "requests refused at admission", labels=("reason",))
        self._m_queue_s = m.histogram(
            "serve_time_in_queue_seconds", "admission -> dispatch wait")
        self._m_request_s = m.histogram(
            "serve_request_seconds", "admission -> resolution wall time")
        self._m_batch = m.histogram(
            "serve_batch_size", "requests per coalesced dispatch",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0))
        self._m_cold = m.counter(
            "serve_cold_queries_total",
            "served queries that compiled at least one program")
        self._m_retries = m.counter(
            "serve_retries_total", "failed attempts handed back for requeue",
            labels=("reason",))
        self._m_partial = m.counter(
            "serve_partial_results_total",
            "requests resolved with a soft-deadline truncated report")
        self._m_breaker = m.gauge(
            "serve_worker_breaker_state",
            "per-worker circuit breaker (0 closed, 1 open)",
            labels=("worker",))
        for w in self.fleet.workers:
            w.breaker_threshold = self.config.breaker_threshold
            self._m_breaker.labels(worker=str(w.wid)).set(0)
        self._rng = random.Random(0)  # deterministic backoff jitter
        self._queue: deque[ServeRequest] = deque()
        self._running = False
        self._loop: asyncio.AbstractEventLoop | None = None
        self._dispatcher: asyncio.Task | None = None
        self._batches: set[asyncio.Task] = set()
        self._retry_timers: dict[int, tuple] = {}  # rid -> (timer, request)
        self._wake = asyncio.Event()

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> int:
        """Warm the fleet and start dispatching; returns programs compiled."""
        if self._running:
            return 0
        self._loop = asyncio.get_running_loop()
        self._running = True
        compiled = await self.fleet.start()
        self._dispatcher = asyncio.create_task(
            self._dispatch_loop(), name="serve-dispatch")
        return compiled

    async def stop(self, *, drain: bool = True) -> None:
        """Stop admitting; drain (default) or cancel the queue; join workers."""
        if not self._running:
            return
        self._running = False  # submit() rejects from here on
        if not drain:
            for req in list(self._queue):
                self.cancel(req)
        self._wake.set()
        if self._dispatcher is not None:
            await self._dispatcher
            self._dispatcher = None
        # drain every batch and the rebuild tasks a finishing batch adds.
        # Wait only on tasks not yet done: a finished task leaves _batches
        # when its discard callback runs, and that callback may still be
        # queued; gather over done tasks returns without yielding, so a
        # loop on `while self._batches` could spin forever.
        while pending := [t for t in self._batches if not t.done()]:
            await asyncio.gather(*pending)
        # flush requeue callbacks still in flight from worker threads, then
        # resolve every request parked in retry backoff as a terminal error
        await asyncio.sleep(0)
        for timer, req in list(self._retry_timers.values()):
            timer.cancel()
            self._fail_retry(req, "scheduler stopped during retry backoff")
        self._retry_timers.clear()
        await self.fleet.shutdown()

    # ------------------------------------------------------------ admission
    @property
    def depth(self) -> int:
        return len(self._queue)

    @property
    def backpressure(self) -> float:
        return len(self._queue) / self.config.queue_capacity

    def submit(self, dataset, query, *, timeout_s: float | None = None,
               client: str = "", stream: ResultStream | None = None,
               ) -> ServeRequest:
        """Admit one request; returns it (await `request.future`).

        Raises `AdmissionError` instead of queueing when the scheduler is
        stopped ("shutting_down") or the queue is full ("queue_full").
        `stream.on_head` is re-dispatched onto this event loop, so client
        callbacks never run on a miner thread.
        """
        if not self._running or self._loop is None:
            self._m_rejected.labels(reason="shutting_down").inc()
            raise AdmissionError("shutting_down",
                                 "scheduler is not accepting requests")
        if len(self._queue) >= self.config.queue_capacity:
            self._m_rejected.labels(reason="queue_full").inc()
            raise AdmissionError(
                "queue_full",
                f"queue at capacity ({self.config.queue_capacity}); "
                "retry with backoff",
            )
        if stream is not None:
            loop, user_cb = self._loop, stream.on_head
            stream = ResultStream(
                head_k=stream.head_k, chunk=stream.chunk,
                on_head=lambda pats: loop.call_soon_threadsafe(user_cb, pats),
            )
        if timeout_s is None:
            timeout_s = self.config.default_timeout_s
        req = ServeRequest(
            dataset, query, client=client, stream=stream,
            signature=program_signature(dataset, query),
            timeout_s=timeout_s, loop=self._loop,
        )
        if req.deadline is not None:
            req.timer = self._loop.call_later(timeout_s, self._expire, req)
        self._queue.append(req)
        self._gauges()
        self._wake.set()
        return req

    def cancel(self, req: ServeRequest) -> bool:
        """Cancel a queued request; False once it started (or finished)."""
        if not req.try_terminate("cancelled"):
            return False
        self._drop(req)
        result = ServeResult(outcome="cancelled", reason="client cancelled",
                             queued_s=req.elapsed(), total_s=req.elapsed())
        self._record(req, result)
        req.resolve(self._loop, result)
        return True

    def _expire(self, req: ServeRequest) -> None:
        if not req.try_terminate("timeout"):
            return  # started first; the worker owns it now
        self._drop(req)
        result = ServeResult(
            outcome="timeout", reason="deadline expired in queue",
            queued_s=req.elapsed(), total_s=req.elapsed(),
        )
        self._record(req, result)
        req.resolve(self._loop, result)

    def _drop(self, req: ServeRequest) -> None:
        try:
            self._queue.remove(req)
        except ValueError:
            pass  # already collected into a batch
        self._gauges()

    def _gauges(self) -> None:
        self._m_depth.set(len(self._queue))
        self._m_pressure.set(self.backpressure)

    def _record(self, req: ServeRequest, result: ServeResult) -> None:
        """Per-result metrics; thread-safe (runs on miner threads too)."""
        self._m_requests.labels(outcome=result.outcome).inc()
        self._m_queue_s.observe(result.queued_s)
        self._m_request_s.observe(result.total_s)
        if result.outcome == "partial":
            self._m_partial.inc()
        if result.ok and result.report is not None and result.report.cold:
            self._m_cold.inc()

    # ---------------------------------------------------------- retry (§11)
    def _ckpt_dir_for(self, req: ServeRequest) -> str | None:
        """Where one request's frontier checkpoints live (None = no ckpt)."""
        root = self.config.ckpt_root
        return os.path.join(root, f"req_{req.rid}") if root else None

    def _on_failure(self, req: ServeRequest, exc, worker) -> bool:
        """Retry-budget decision for one failed attempt (worker thread).

        True => the request was reset to queued and a backoff requeue is
        armed on the loop; the caller leaves its future pending.  False =>
        budget exhausted (or the scheduler is stopping): the caller resolves
        the request as a terminal error.
        """
        if not self._running:
            return False
        if req.attempts > self.config.max_retries:
            return False  # attempt 1 + max_retries retries all consumed
        if not req.reset_for_retry():
            return False  # a terminal transition won the race
        self._m_retries.labels(reason=type(exc).__name__).inc()
        self._loop.call_soon_threadsafe(self._arm_requeue, req)
        return True

    def _arm_requeue(self, req: ServeRequest) -> None:
        """Schedule the delayed requeue of a reset request (loop thread).

        Backoff doubles per retry (attempt 2 waits the base delay) with
        deterministic uniform jitter so same-worker retries decorrelate.
        """
        if not self._running:
            self._fail_retry(req, "scheduler stopped before retry")
            return
        backoff = (self.config.retry_backoff_s * 2 ** (req.attempts - 2)
                   * (1.0 + self.config.retry_jitter * self._rng.random()))
        timer = self._loop.call_later(backoff, self._requeue, req)
        self._retry_timers[req.rid] = (timer, req)

    def _requeue(self, req: ServeRequest) -> None:
        """Put a backed-off request at the queue tail (loop thread).

        Bypasses admission capacity on purpose: the request was already
        admitted once and holds a pending client future.  Skips silently if
        a deadline/cancel resolved it while parked.
        """
        self._retry_timers.pop(req.rid, None)
        if req.state != "queued":
            return
        if not self._running:
            self._fail_retry(req, "scheduler stopped during retry backoff")
            return
        self._queue.append(req)
        self._gauges()
        self._wake.set()

    def _requeue_now(self, req: ServeRequest) -> None:
        """Immediate no-penalty requeue for requests whose batch runner died
        before their attempt started (loop thread): no backoff, no attempt
        bump — the request itself never failed."""
        if req.state != "queued":
            return
        self._queue.append(req)
        self._gauges()
        self._wake.set()

    def _fail_retry(self, req: ServeRequest, why: str) -> None:
        """Terminal error for a request stuck in retry limbo (loop thread)."""
        if not req.try_terminate("error"):
            return
        result = ServeResult(
            outcome="error", reason=why, queued_s=req.elapsed(),
            total_s=req.elapsed(), attempts=req.attempts,
        )
        self._record(req, result)
        req.resolve(self._loop, result)

    async def _rebuild_worker(self, worker) -> None:
        """Swap a tripped worker's session for a fresh one on its own thread,
        then close its breaker.  A rebuild that itself raises leaves the
        breaker open permanently (graceful degradation: the fleet keeps
        serving on the survivors)."""
        try:
            await self._loop.run_in_executor(
                worker.executor, self.fleet.rebuild_worker, worker)
        except Exception:
            return  # breaker stays open, rebuilding stays latched
        self._m_breaker.labels(worker=str(worker.wid)).set(0)
        self.fleet.note_repaired(worker)

    # ------------------------------------------------------------- dispatch
    async def _dispatch_loop(self) -> None:
        while self._running or self._queue:
            if not self._queue:
                self._wake.clear()
                if not self._running:
                    break
                await self._wake.wait()
                continue
            head = self._queue[0]
            worker = await self.fleet.acquire(head.signature, head.dataset)
            # the queue may have drained (expiry/cancel) while we waited
            if not self._queue:
                self.fleet.release(worker)
                continue
            # fairness: never batch so greedily that other idle workers
            # starve — split a deep queue across every available session
            avail = 1 + sum(1 for w in self.fleet.workers
                            if not w.busy and not w.broken)
            limit = min(self.config.max_batch,
                        -(-len(self._queue) // avail))
            batch = collect_batch(self._queue, limit)
            self._gauges()
            if not batch:
                self.fleet.release(worker)
                continue
            self._m_batch.observe(len(batch))
            task = asyncio.create_task(self._run_batch(worker, batch))
            self._batches.add(task)
            task.add_done_callback(self._batches.discard)

    async def _run_batch(self, worker, batch) -> None:
        try:
            await self._loop.run_in_executor(
                worker.executor, run_batch, worker, batch, self._loop,
                self._record, self._on_failure, self._ckpt_dir_for,
            )
        except Exception as exc:
            # the batch RUNNER died (not one request's engine call — those
            # are caught inside run_batch): nothing in this batch may be
            # lost.  Never-started members requeue free; the in-flight one
            # burns an attempt through the normal retry budget.
            worker.record_failure()
            for req in batch:
                if req.state == "queued":
                    self._requeue_now(req)
                elif req.state == "running":
                    if self._on_failure(req, exc, worker):
                        pass  # reset + requeue armed; retry counted inside
                    elif req.try_terminate_running("error"):
                        result = ServeResult(
                            outcome="error",
                            reason=f"batch runner died: "
                                   f"{type(exc).__name__}: {exc}",
                            queued_s=req.elapsed(), total_s=req.elapsed(),
                            session_id=worker.wid, attempts=req.attempts,
                        )
                        self._record(req, result)
                        req.resolve(self._loop, result)
        finally:
            self.fleet.release(worker)
            if worker.broken and not worker.rebuilding:
                worker.rebuilding = True
                self._m_breaker.labels(worker=str(worker.wid)).set(1)
                task = asyncio.create_task(
                    self._rebuild_worker(worker),
                    name=f"serve-rebuild-{worker.wid}")
                self._batches.add(task)
                task.add_done_callback(self._batches.discard)
            self._wake.set()


class MiningService:
    """Fleet + scheduler + one metrics surface: the thing you start.

    `size` sessions of `n_miners` virtual miners each, all on `device`
    (default: the card; "cpu" runs on the CPU), one CUDA stream per worker.

        service = MiningService(size=2, warmups=[WarmupSpec(bucket)])
        await service.start()
        result = await service.mine(dataset, SignificantPatternQuery(alpha=0.05))
        await service.stop()
    """

    def __init__(self, *, size: int = 2, n_miners: int = 1, device=None,
                 algorithm=None, runtime=None,
                 config: ServeConfig | None = None, warmups=(),
                 metrics: MetricsRegistry | None = None,
                 residency_budget_mb: float = 256.0):
        self.metrics = metrics or MetricsRegistry()
        self.fleet = SessionFleet.build(
            size, n_miners=n_miners, device=device, algorithm=algorithm,
            runtime=runtime, metrics=self.metrics, warmups=warmups,
            residency_budget_mb=residency_budget_mb,
        )
        self.scheduler = Scheduler(self.fleet, config, metrics=self.metrics)

    async def start(self) -> int:
        return await self.scheduler.start()

    async def stop(self, *, drain: bool = True) -> None:
        await self.scheduler.stop(drain=drain)

    def submit(self, dataset, query, **kw) -> ServeRequest:
        return self.scheduler.submit(dataset, query, **kw)

    async def mine(self, dataset, query, **kw) -> ServeResult:
        """Submit and await one request (admission errors still raise)."""
        return await self.submit(dataset, query, **kw).future

    def cancel(self, req: ServeRequest) -> bool:
        return self.scheduler.cancel(req)

    @property
    def depth(self) -> int:
        return self.scheduler.depth

    @property
    def backpressure(self) -> float:
        return self.scheduler.backpressure

    @property
    def size(self) -> int:
        return self.fleet.size
