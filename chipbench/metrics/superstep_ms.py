"""Host milliseconds per superstep of the engine's loop: the `dispatch`
spans' time over the supersteps the phases report."""


def read(trace):
    steps = sum(r["supersteps"] for r in trace.requests)
    if not steps:
        return None
    us = sum(e["dur"] for r in trace.requests for e in r["spans"] if e["name"] == "dispatch")
    return us / steps / 1e3
