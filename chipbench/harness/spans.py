"""Per-query and per-superstep sums of the program's spans, for the
readers of the spans beneath the query (`metrics/*.py`).

Each reads the session driver's requests outside the profiled stretches
(`Trace.requests`) and returns None where no request holds the span: a
program that does not record it.
"""

from __future__ import annotations

__all__ = ["per_query_ms", "per_superstep_ms"]


def _total_us(trace, name: str):
    """(microseconds in the spans `name`, requests with spans), or None
    where no request holds such a span."""
    reqs = [r for r in trace.requests if r["spans"]]
    durs = [e["dur"] for r in reqs for e in r["spans"] if e["name"] == name]
    if not durs:
        return None
    return sum(durs), len(reqs)


def per_query_ms(trace, name: str) -> float | None:
    """Milliseconds a query in the spans `name`."""
    got = _total_us(trace, name)
    return None if got is None else got[0] / got[1] / 1e3


def per_superstep_ms(trace, name: str) -> float | None:
    """Milliseconds a superstep in the spans `name`: their time over the
    `superstep` spans counted."""
    got = _total_us(trace, name)
    steps = sum(1 for r in trace.requests for e in r["spans"] if e["name"] == "superstep")
    return None if got is None or not steps else got[0] / steps / 1e3
