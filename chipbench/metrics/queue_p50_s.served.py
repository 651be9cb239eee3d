"""Median seconds a served request waited from admission to its start
(`ServeResult.queued_s`), over the window's answered requests."""

from chipbench.harness.stats import percentile


def read(trace):
    waits = [r["queued_s"] for r in trace.served if r["ok"]]
    if not waits:
        return None
    return percentile(waits, 50)
