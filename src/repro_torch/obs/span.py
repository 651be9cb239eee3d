"""Host span tracer — nested timing spans with Chrome-trace export.

Counterpart of `repro.obs.span`.  A `SpanTracer` is a context-manager
factory::

    tracer = SpanTracer()
    with tracer.span("phase:count", mode="count"):
        with tracer.span("dispatch"):
            ...
    tracer.save("trace.json")          # open in ui.perfetto.dev / chrome://tracing

Spans record wall-clock complete events (Chrome trace ``ph: "X"``) with
microsecond timestamps relative to the tracer's epoch; nesting follows the
with-statement structure.  `MinerSession` owns a tracer by default and
wraps every phase of every query (pack, compile, dispatch, postprocess,
reconstruct).

`torch_profiler=True` additionally enters a
``torch.profiler.record_function`` per span, so a `torch.profiler.profile`
capture shows the host spans beside the device kernels they launched (the
JAX version bridges to ``jax.profiler.TraceAnnotation`` the same way).
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager

import torch

__all__ = ["SpanTracer"]


class SpanTracer:
    """Collects nested wall-clock spans; exports Chrome-trace JSON."""

    def __init__(self, *, torch_profiler: bool = False):
        self.torch_profiler = torch_profiler
        self._events: list[dict] = []
        self._epoch_ns = time.perf_counter_ns()
        self._lock = threading.Lock()

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._epoch_ns) / 1e3

    @contextmanager
    def span(self, name: str, **args):
        """Time a nested region; extra kwargs land in the event's args."""
        ann = (torch.profiler.record_function(name) if self.torch_profiler
               else None)
        if ann is not None:
            ann.__enter__()
        t0 = self._now_us()
        try:
            yield self
        finally:
            t1 = self._now_us()
            if ann is not None:
                ann.__exit__(None, None, None)
            event = {
                "name": name,
                "ph": "X",
                "ts": t0,
                "dur": t1 - t0,
                "pid": os.getpid(),
                "tid": threading.get_ident() & 0xFFFF,
            }
            if args:
                event["args"] = {k: _jsonable(v) for k, v in args.items()}
            with self._lock:
                self._events.append(event)

    # ------------------------------------------------------------- export
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def to_chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object (ts/dur in microseconds)."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1)
            f.write("\n")
        return path


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)
