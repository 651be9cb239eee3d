"""Load generation against a MiningService (counterpart of
`repro.serve.loadgen`; DESIGN.md §10).

Two standard serving-benchmark modes:

  * **open loop** — Poisson arrivals at a target offered qps, submitted
    regardless of completion (the honest tail-latency measurement: queue
    growth, admission rejections and timeouts all show up instead of the
    closed-loop coordinated-omission artifact);
  * **closed loop** — `concurrency` clients, each submitting its next
    query the moment the previous resolves (the throughput ceiling
    measurement).

Work items are *pre-built* `(dataset, query)` pairs: dataset construction
and packing is client-side work and must not pollute service latency.
Both runners cycle the item list when asked for more requests than items.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass, field

from .request import AdmissionError
from .stats_util import latency_summary

__all__ = ["LoadReport", "run_closed_loop", "run_open_loop"]


@dataclass
class LoadReport:
    """What one load-generation run measured."""

    mode: str                       # "open" | "closed"
    offered_qps: float | None       # open loop: the arrival-rate target
    concurrency: int | None         # closed loop: in-flight clients
    n_requests: int = 0             # arrivals (admitted + rejected)
    n_ok: int = 0
    n_partial: int = 0              # soft-deadline truncated reports
    n_rejected: int = 0             # AdmissionError at submit
    n_timeout: int = 0
    n_cancelled: int = 0
    n_error: int = 0
    n_retried: int = 0              # resolved requests that took > 1 attempt
    duration_s: float = 0.0         # first arrival -> last resolution
    latencies_s: list = field(default_factory=list)   # ok requests only
    queue_s: list = field(default_factory=list)       # ok time-in-queue
    depth_samples: list = field(default_factory=list)  # queue depth/arrival
    cold_ok: int = 0                # ok requests that compiled something

    @property
    def achieved_qps(self) -> float:
        return self.n_ok / self.duration_s if self.duration_s > 0 else 0.0

    @property
    def rejection_rate(self) -> float:
        return self.n_rejected / self.n_requests if self.n_requests else 0.0

    def as_dict(self) -> dict:
        d = {
            "mode": self.mode,
            "offered_qps": self.offered_qps,
            "concurrency": self.concurrency,
            "n_requests": self.n_requests,
            "n_ok": self.n_ok,
            "n_partial": self.n_partial,
            "n_rejected": self.n_rejected,
            "n_timeout": self.n_timeout,
            "n_cancelled": self.n_cancelled,
            "n_error": self.n_error,
            "n_retried": self.n_retried,
            "duration_s": round(self.duration_s, 3),
            "achieved_qps": round(self.achieved_qps, 3),
            "rejection_rate": round(self.rejection_rate, 4),
            "cold_ok": self.cold_ok,
        }
        d.update(latency_summary(self.latencies_s, prefix="latency_"))
        d.update(latency_summary(self.queue_s, prefix="queue_"))
        if self.depth_samples:
            d["depth_mean"] = round(
                sum(self.depth_samples) / len(self.depth_samples), 2)
            d["depth_max"] = max(self.depth_samples)
        return d

    def _absorb(self, result) -> None:
        if getattr(result, "attempts", 1) > 1:
            self.n_retried += 1
        if result.ok:
            self.n_ok += 1
            self.latencies_s.append(result.total_s)
            self.queue_s.append(result.queued_s)
            if result.report is not None and result.report.cold:
                self.cold_ok += 1
        elif result.outcome == "partial":
            self.n_partial += 1  # a real (truncated) report, not a failure
        elif result.outcome == "timeout":
            self.n_timeout += 1
        elif result.outcome == "cancelled":
            self.n_cancelled += 1
        else:
            self.n_error += 1


async def run_open_loop(service, work, *, qps: float, n_requests: int,
                        seed: int = 0, timeout_s: float | None = None,
                        client: str = "loadgen") -> LoadReport:
    """Fire `n_requests` Poisson arrivals at `qps` against `service`.

    Arrivals never wait for completions; rejected submissions are counted
    and dropped (the open-loop clock keeps ticking).  `work` is a sequence
    of pre-built (dataset, query) pairs, cycled.
    """
    if qps <= 0:
        raise ValueError(f"qps must be positive, got {qps}")
    if not work:
        raise ValueError("run_open_loop needs at least one work item")
    rng = random.Random(seed)
    report = LoadReport(mode="open", offered_qps=qps, concurrency=None)
    pending = []
    t0 = time.perf_counter()
    due = t0
    for i in range(n_requests):
        delay = due - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        due += rng.expovariate(qps)
        dataset, query = work[i % len(work)]
        report.n_requests += 1
        report.depth_samples.append(service.depth)
        try:
            req = service.submit(dataset, query, timeout_s=timeout_s,
                                 client=f"{client}-{i}")
        except AdmissionError:
            report.n_rejected += 1
            continue
        pending.append(req.future)
    for result in await asyncio.gather(*pending):
        report._absorb(result)
    report.duration_s = time.perf_counter() - t0
    return report


async def run_closed_loop(service, work, *, concurrency: int,
                          n_requests: int, timeout_s: float | None = None,
                          client: str = "loadgen") -> LoadReport:
    """`concurrency` always-busy clients issuing `n_requests` total."""
    if concurrency < 1:
        raise ValueError(f"concurrency must be >= 1, got {concurrency}")
    if not work:
        raise ValueError("run_closed_loop needs at least one work item")
    report = LoadReport(mode="closed", offered_qps=None,
                        concurrency=concurrency)
    counter = iter(range(n_requests))
    t0 = time.perf_counter()

    async def _client(cid: int) -> None:
        for i in counter:
            dataset, query = work[i % len(work)]
            report.n_requests += 1
            report.depth_samples.append(service.depth)
            try:
                result = await service.mine(
                    dataset, query, timeout_s=timeout_s,
                    client=f"{client}-c{cid}",
                )
            except AdmissionError:
                report.n_rejected += 1
                continue
            report._absorb(result)

    await asyncio.gather(*[_client(c) for c in range(concurrency)])
    report.duration_s = time.perf_counter() - t0
    return report
