"""repro_torch.obs — host observability (counterpart of `repro.obs`).

  span.py     host span tracer — nested context-manager spans around
              pack/compile/dispatch/postprocess/reconstruct, exported as
              Chrome-trace (Perfetto) JSON, with an optional
              torch.profiler bridge so host spans sit beside the kernels.
  metrics.py  metrics registry — counters/gauges/histograms with
              Prometheus text exposition, fed by MinerSession.
  log.py      structured JSON-lines run records for the launcher.

The device superstep trace ring (`repro.obs.trace`) and the artifact
validators (`repro.obs.validate`) are not ported yet (ROADMAP.md queue 1,
item 7).
"""

from .log import JsonlLogger
from .metrics import DEFAULT_LATENCY_BUCKETS, MetricsRegistry
from .span import SpanTracer

__all__ = [
    "DEFAULT_LATENCY_BUCKETS",
    "JsonlLogger",
    "MetricsRegistry",
    "SpanTracer",
]
