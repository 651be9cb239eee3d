"""repro_torch.obs — observability (counterpart of `repro.obs`).

  trace.py    device superstep trace — a [P, trace_cap, N_FIELDS] int32
              ring in the BSP carry, sampled every trace_period
              supersteps, decoded host-side into per-miner timelines and
              load-balance metrics.
  span.py     host span tracer — nested context-manager spans around
              each query, phase, superstep and reconstruction step and
              each served request, kept in a bounded ring and exported
              as Chrome-trace (Perfetto) JSON, with an optional
              torch.profiler bridge so host spans sit beside the kernels.
  metrics.py  metrics registry — counters/gauges/histograms with
              Prometheus text exposition, fed by MinerSession.
  log.py      structured JSON-lines run records for the launcher.
  validate.py artifact schema validators
              (`python -m repro_torch.obs.validate --chrome t.json --prom m.prom`).
"""

from .log import JsonlLogger
from .metrics import DEFAULT_LATENCY_BUCKETS, MetricsRegistry
from .span import NULL_TRACER, SpanTracer
from .trace import (
    DEFAULT_TRACE_CAP,
    N_FIELDS,
    SuperstepTrace,
    TraceField,
    decode_trace,
    jain_fairness,
)

__all__ = [
    "DEFAULT_LATENCY_BUCKETS",
    "DEFAULT_TRACE_CAP",
    "JsonlLogger",
    "MetricsRegistry",
    "NULL_TRACER",
    "N_FIELDS",
    "SpanTracer",
    "SuperstepTrace",
    "TraceField",
    "decode_trace",
    "jain_fairness",
]
