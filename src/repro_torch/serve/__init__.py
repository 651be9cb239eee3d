"""repro_torch.serve — the async mining service (counterpart of
`repro.serve`; DESIGN.md §10).

An asyncio scheduler (bounded queue, admission control, deadlines,
cancellation, backpressure) in front of a fleet of warm `MinerSession`s
(startup warmup of configured shape buckets, dataset residency, warm-
program affinity dispatch), with same-program batching, streaming
top-k-first delivery, and an open/closed-loop load generator.

    from repro_torch.serve import MiningService, WarmupSpec

    service = MiningService(size=2, warmups=[WarmupSpec(dataset.bucket)])
    await service.start()
    result = await service.mine(dataset, SignificantPatternQuery(alpha=0.05))
    await service.stop()
"""

from .batch import ProgramSignature, collect_batch, program_signature
from .fleet import FleetWorker, SessionFleet, WarmupSpec
from .loadgen import LoadReport, run_closed_loop, run_open_loop
from .request import AdmissionError, ServeRequest, ServeResult
from .scheduler import MiningService, Scheduler, ServeConfig
from .stats_util import latency_histogram, latency_summary, percentile

__all__ = [
    "AdmissionError",
    "FleetWorker",
    "LoadReport",
    "MiningService",
    "ProgramSignature",
    "Scheduler",
    "ServeConfig",
    "ServeRequest",
    "ServeResult",
    "SessionFleet",
    "WarmupSpec",
    "collect_batch",
    "latency_histogram",
    "latency_summary",
    "percentile",
    "program_signature",
    "run_closed_loop",
    "run_open_loop",
]
