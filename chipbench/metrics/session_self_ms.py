"""Host milliseconds per query that the session spends outside its phases
and reconstruction: each `query:*` span less what its inner spans cover."""

from chipbench.harness.tracectx import span_self_us


def read(trace):
    reqs = [r for r in trace.requests if r["spans"]]
    if not reqs:
        return None
    return sum(span_self_us(r["spans"], "query:") for r in reqs) / len(reqs) / 1e3
