"""95th percentile (nearest rank) of the seconds from a served request's
submission to its resolution, over every request of the window; a failed
request counts as the whole window."""

from chipbench.harness.stats import percentile


def read(trace):
    totals = [r["total_s"] for r in trace.served]
    if not totals:
        return None
    return percentile(totals, 95)
