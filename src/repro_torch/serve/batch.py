"""Same-program batching for the serving scheduler (counterpart of
`repro.serve.batch`; DESIGN.md §10).

Two requests share a *program signature* when a warm session could serve
them back-to-back with zero compiles: same shape bucket, same traced
statistic, same staging.  `collect_batch` coalesces the queue head with
every same-signature request behind it (FIFO order within the batch is
preserved — clients that submitted earlier complete earlier), and
`run_batch` drains the coalesced batch on one fleet worker's thread,
resolving each request's future the moment its report is ready (the k-th
request of a batch does not wait for the batch).

Cancellation granularity: a queued request can be cancelled or expired,
a *running* one cannot — the engine's BSP supersteps are not
interruptible mid-dispatch — so `run_batch` re-checks each request's
deadline at start time (`try_start`) and resolves late ones as timeouts
without touching the device.

Each request runs inside its worker's `device_scope()`: on the card, on
the worker's own CUDA stream, after the work queued on the default stream
(the client's dataset uploads) and synchronised before the request
resolves.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from repro_torch.api.dataset import Dataset, ShapeBucket
from repro_torch.api.query import (
    ClosedFrequentQuery,
    Query,
    SignificantPatternQuery,
    TopKSignificantQuery,
)

from .request import ServeRequest, ServeResult

__all__ = ["BatchStats", "ProgramSignature", "collect_batch",
           "program_signature", "run_batch"]


@dataclass(frozen=True)
class ProgramSignature:
    """What a compiled-program working set depends on, per request.

    Equal signatures => the same warm session serves both with zero
    compiles, so they may coalesce into one batch.  `pipeline` is the LAMP
    staging whose phase modes the request replays; objectives outside the
    stagings (top-k bisection, closed-frequent) ride "three_phase"'s
    "test" program, so they map onto it for affinity purposes.
    """

    bucket: ShapeBucket
    statistic: str | None
    pipeline: str

    def warm_on(self, session) -> bool:
        """True when `session` already holds every compiled program this
        request needs (the fleet's affinity predicate)."""
        return session.has_programs(self.bucket, self.statistic,
                                    pipeline=self.pipeline)


def program_signature(dataset: Dataset, query: Query) -> ProgramSignature:
    """Batching/affinity identity of one (dataset, query) request."""
    bucket = dataset.bucket
    if isinstance(query, SignificantPatternQuery):
        return ProgramSignature(bucket, query.statistic, query.pipeline)
    if isinstance(query, TopKSignificantQuery):
        # bisection probes replay the "test" program of the classic staging
        return ProgramSignature(bucket, query.statistic, "three_phase")
    if isinstance(query, ClosedFrequentQuery):
        return ProgramSignature(bucket, None, "three_phase")
    # unknown objective: conservative identity from declared attributes
    return ProgramSignature(bucket, getattr(query, "statistic", None),
                            getattr(query, "pipeline", "three_phase"))


def collect_batch(queue, max_batch: int) -> list[ServeRequest]:
    """Pop the queue head plus up to `max_batch - 1` same-signature
    requests behind it, preserving FIFO order.  Other-signature requests
    keep their queue positions.  Loop-thread only (the queue is not
    locked)."""
    if not queue:
        return []
    head = queue.popleft()
    batch = [head]
    if max_batch > 1:
        rest = []
        while queue and len(batch) < max_batch:
            req = queue.popleft()
            if req.signature == head.signature:
                batch.append(req)
            else:
                rest.append(req)
        for req in reversed(rest):
            queue.appendleft(req)
    return batch


@dataclass
class BatchStats:
    """What one drained batch did (scheduler metrics feed)."""

    n_ok: int = 0
    n_timeout: int = 0
    n_error: int = 0
    n_cold: int = 0          # ok queries whose report compiled anything
    service_s: float = 0.0   # summed engine+result wall time
    n_partial: int = 0       # soft-deadline stops (truncated reports)
    n_retried: int = 0       # failed attempts handed back for requeue


def _ckpt_capable(worker) -> bool:
    """True when the worker's session runs the segmented program — the only
    program with superstep boundaries to stop at or checkpoint from."""
    return bool(getattr(getattr(worker.session, "runtime", None),
                        "ckpt_period", 0))


def run_batch(worker, batch: list[ServeRequest], loop,
              on_result=None, on_failure=None,
              ckpt_dir_for=None) -> BatchStats:
    """Drain one coalesced batch on `worker`'s session (worker thread).

    Each request's future resolves (thread-safely, on the loop) as soon as
    its own report is ready.  `on_result(request, result)` — optional —
    fires on this worker thread right before resolution; implementations
    must be thread-safe (the scheduler passes its metrics recorder).

    Fault tolerance (DESIGN.md §11): `on_failure(request, exc, worker)` —
    optional — decides retry vs terminal error for a failed attempt; when
    it returns True the request has been handed back to the scheduler
    (future left pending) and this runner moves on.  On a ckpt-capable
    session a deadlined request gets an engine-cooperative `should_stop`
    (stop at a superstep boundary, outcome "partial" with a truncated
    report) and `ckpt_dir_for(request)` names where its frontier
    checkpoints go.
    """
    from repro_torch.testing import faults

    stats = BatchStats()
    size = len(batch)
    capable = _ckpt_capable(worker)
    for i, req in enumerate(batch):
        now = time.perf_counter()
        if not req.try_start():
            # lost the race to a terminator (its timer already resolved the
            # future), or the deadline lapsed in-queue before any timer
            # fired — resolve the latter here
            if req.try_terminate("timeout"):
                result = ServeResult(
                    outcome="timeout",
                    reason="deadline expired before dispatch",
                    queued_s=now - req.submitted,
                    total_s=now - req.submitted,
                    session_id=worker.wid, batch_size=size, batch_index=i,
                    attempts=req.attempts,
                )
                stats.n_timeout += 1
                if on_result is not None:
                    on_result(req, result)
                req.resolve(loop, result)
            continue
        try:
            faults.check("serve.attempt", rid=req.rid, worker=worker.wid)
            kw = {}
            if capable:
                if req.deadline is not None:
                    kw["should_stop"] = (
                        lambda d=req.deadline: time.perf_counter() >= d)
                ckpt_dir = (ckpt_dir_for(req)
                            if ckpt_dir_for is not None else None)
                if ckpt_dir:
                    kw["ckpt_dir"] = ckpt_dir
            with worker.device_scope():
                report = worker.session.run(req.dataset, req.query,
                                            stream=req.stream, **kw)
        except Exception as exc:  # engine/query failure -> retry or fail
            worker.record_failure()
            end = time.perf_counter()
            started = req.started
            if on_failure is not None and on_failure(req, exc, worker):
                # handed back to the scheduler: the future stays pending and
                # the request is (or will be) queued again
                stats.n_retried += 1
                continue
            req.finish("error")
            result = ServeResult(
                outcome="error",
                reason=f"{type(exc).__name__}: {exc}",
                queued_s=started - req.submitted,
                service_s=end - started,
                total_s=end - req.submitted,
                session_id=worker.wid, batch_size=size, batch_index=i,
                attempts=req.attempts,
            )
            stats.n_error += 1
        else:
            worker.record_success()
            partial = bool(getattr(report, "partial", False))
            req.finish("partial" if partial else "ok")
            end = time.perf_counter()
            result = ServeResult(
                outcome="partial" if partial else "ok", report=report,
                queued_s=req.started - req.submitted,
                service_s=end - req.started,
                total_s=end - req.submitted,
                session_id=worker.wid, batch_size=size, batch_index=i,
                attempts=req.attempts,
                ckpt_path=getattr(report, "ckpt_path", None),
            )
            if partial:
                stats.n_partial += 1
            else:
                stats.n_ok += 1
            stats.n_cold += 1 if report.cold else 0
            stats.service_s += result.service_s
            worker.note_served(req.dataset)
        if on_result is not None:
            on_result(req, result)
        req.resolve(loop, result)
    return stats
