"""Milliseconds per query of the results layer: the `reconstruct` span
(closure reconstruction, dedup, float64 P- and q-values)."""


def read(trace):
    reqs = [r for r in trace.requests if r["spans"]]
    if not reqs:
        return None
    us = sum(e["dur"] for r in reqs for e in r["spans"] if e["name"] == "reconstruct")
    return us / len(reqs) / 1e3
