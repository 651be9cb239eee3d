"""Host span tracer — nested timing spans with Chrome-trace export.

Counterpart of `repro.obs.span`.  A `SpanTracer` is a context-manager
factory::

    tracer = SpanTracer()
    with tracer.span("phase:count", mode="count"):
        with tracer.span("dispatch"):
            ...
    tracer.save("trace.json")          # open in ui.perfetto.dev / chrome://tracing

Spans record wall-clock complete events (Chrome trace ``ph: "X"``) with
microsecond timestamps relative to the tracer's `epoch_ns` on
`time.perf_counter_ns`; nesting follows the with-statement structure, and
``tid`` is the OS thread id (`threading.get_native_id()`), the one
`torch.profiler` reports.  `MinerSession` owns a tracer by default and
wraps every query, phase and superstep, and the result's reconstruction;
the serving layer adds one span per request.

The tracer keeps the newest `max_events` events in a ring and counts the
ones it overwrote in `dropped`, so a long-lived service holds bounded
memory.  `NULL_TRACER` records nothing: the engine's and the results
layer's default where no tracer is passed.

`torch_profiler=True` additionally enters a
``torch.profiler.record_function`` per span, so a `torch.profiler.profile`
capture shows the host spans beside the device kernels they launched (the
JAX version bridges to ``jax.profiler.TraceAnnotation`` the same way).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque

import torch

__all__ = ["DEFAULT_MAX_EVENTS", "NULL_TRACER", "SpanTracer"]

#: events a tracer keeps by default: a closed query of one to three
#: supersteps records about 25, so this holds some 2,600 of them
DEFAULT_MAX_EVENTS = 65_536


class SpanTracer:
    """Collects nested wall-clock spans; exports Chrome-trace JSON."""

    def __init__(self, *, torch_profiler: bool = False,
                 max_events: int = DEFAULT_MAX_EVENTS):
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self.torch_profiler = torch_profiler
        self.max_events = int(max_events)
        #: events overwritten by the ring since the tracer was made
        self.dropped = 0
        #: `time.perf_counter_ns()` at ts == 0
        self.epoch_ns = time.perf_counter_ns()
        self._events: deque[dict] = deque(maxlen=self.max_events)
        self._lock = threading.Lock()

    def span(self, name: str, **args) -> "_Span":
        """Time a nested region; extra kwargs land in the event's args.

        The context yields that args dict: keys the body sets land in the
        event too."""
        return _Span(self, name, args)

    def _record(self, name: str, t0_ns: int, t1_ns: int, args: dict) -> None:
        event = {
            "name": name,
            "ph": "X",
            "ts": (t0_ns - self.epoch_ns) / 1e3,
            "dur": (t1_ns - t0_ns) / 1e3,
            "pid": os.getpid(),
            # the OS thread id without a system call
            "tid": threading.current_thread().native_id,
        }
        if args:
            event["args"] = {k: _jsonable(v) for k, v in args.items()}
        with self._lock:
            if len(self._events) == self.max_events:
                self.dropped += 1
            self._events.append(event)

    # ------------------------------------------------------------- export
    def events(self) -> list[dict]:
        """The kept events, oldest first."""
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        """Forget the kept events (`dropped` keeps counting)."""
        with self._lock:
            self._events.clear()

    def to_chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object (ts/dur in microseconds from
        `otherData.epoch_ns` on `time.perf_counter_ns`)."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms",
                "otherData": {"epoch_ns": self.epoch_ns}}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1)
            f.write("\n")
        return path


class _Span:
    """One span of a `SpanTracer`, as a context manager (a class, not a
    generator: the loop enters several a superstep)."""

    __slots__ = ("tracer", "name", "args", "ann", "t0")

    def __init__(self, tracer: SpanTracer, name: str, args: dict):
        self.tracer, self.name, self.args = tracer, name, args

    def __enter__(self) -> dict:
        self.ann = None
        if self.tracer.torch_profiler:
            self.ann = torch.profiler.record_function(self.name)
            self.ann.__enter__()
        self.t0 = time.perf_counter_ns()
        return self.args

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        if self.ann is not None:
            self.ann.__exit__(None, None, None)
        self.tracer._record(self.name, self.t0, t1, self.args)
        return False


class _NullTracer:
    """Records nothing: `span()` is one shared no-op context (it yields
    None, where `SpanTracer.span` yields the args dict)."""

    _SPAN = contextlib.nullcontext()

    def span(self, name: str, **args):
        return self._SPAN


NULL_TRACER = _NullTracer()


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)
