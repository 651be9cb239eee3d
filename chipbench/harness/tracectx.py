"""What a traced run hands each per-layer metric's reader.

A reader (`metrics/<name>.py::read(trace)`) returns a number, or None
when this run holds nothing for it to read; the harness then leaves the
metric out of the result line.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["Trace", "span_self_us", "union_us"]


@dataclass
class Trace:
    driver: str                    # "session" | "served"
    #: requests of the window outside the profiled stretches:
    #: {"wall_s", "supersteps", "spans": [Chrome-trace events of the session]}
    requests: list = field(default_factory=list)
    #: the profiled stretch: {"window_s", "busy_s", "intervals": [(name,
    #: start us, end us)], "launch_shapes": {(B, M, W): launches},
    #: "supersteps", "nodes" (popped), "expand_rows" (EXPAND's batch)}
    #: (the last four None where requests overlap), or None
    device: dict | None = None
    #: served requests of the window: {"ok", "queued_s", "total_s"}, where
    #: `total_s` runs from submission to resolution, and a failed request's
    #: is the whole window
    served: list = field(default_factory=list)
    #: the datasets' exact sizes: {"items", "words", "transactions"}
    dims: dict = field(default_factory=dict)
    #: the host-and-device stretch (the harness's, for the breakdown) and
    #: the session's spans in it: [(name, start us, end us, thread)]
    host_prof: object = None
    host_spans: list = field(default_factory=list)


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > reach:
            total += hi - max(lo, reach)
            reach = hi
    return total


def span_self_us(spans: list, name_prefix: str) -> float:
    """Duration of the spans whose name starts with `name_prefix`, less the
    part that the other spans inside them cover (their self time)."""
    total = 0.0
    for s in spans:
        if not s["name"].startswith(name_prefix):
            continue
        lo, hi = s["ts"], s["ts"] + s["dur"]
        inner = [(max(c["ts"], lo), min(c["ts"] + c["dur"], hi)) for c in spans
                 if c is not s and c.get("tid") == s.get("tid")
                 and c["ts"] < hi and c["ts"] + c["dur"] > lo]
        total += (hi - lo) - union_us([iv for iv in inner if iv[1] > iv[0]])
    return total
