"""Milliseconds per query that rank 0 of a cluster cell spends in its
process group's collectives (`MinerGroup.seconds`: each gloo round trip
with its host staging copies, the census and steal exchanges of every
superstep, the census sums and the outputs' gathers): the median over the
requests outside the profiled stretches.  None in a run of one process."""

from chipbench.harness.stats import percentile


def read(trace):
    per_query = [r["collective_s"] for r in trace.requests if "collective_s" in r]
    return percentile(per_query, 50) * 1e3 if per_query else None
