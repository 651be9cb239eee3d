"""Structured JSON-lines run records for the launcher (a copy of `repro.obs.log`).

One record per line, one ``event`` key naming the record type, everything
else flat JSON-able fields — the format every log shipper ingests without
configuration.  The launcher uses this instead of ad-hoc prints when
``--verbose`` is set::

    log = JsonlLogger()                       # stderr by default
    log.event("phase", mode="count", wall_s=0.14, cache_hit=True)
    # {"ts": 1754700000.123456, "event": "phase", "mode": "count", ...}

Values that aren't JSON-serializable are stringified rather than raised on:
a telemetry path must never take the run down.
"""

from __future__ import annotations

import json
import sys
import time

__all__ = ["JsonlLogger"]


class JsonlLogger:
    """Writes one JSON object per line to a stream (default: stderr)."""

    def __init__(self, stream=None, *, clock=time.time):
        self.stream = stream if stream is not None else sys.stderr
        self._clock = clock

    def event(self, event: str, **fields) -> dict:
        """Emit one record; returns the dict that was written."""
        rec = {"ts": round(self._clock(), 6), "event": event, **fields}
        self.stream.write(json.dumps(rec, default=str) + "\n")
        flush = getattr(self.stream, "flush", None)
        if flush is not None:
            flush()
        return rec
