"""Share of the engine's supersteps run as one replay of a CUDA graph: the
`superstep` spans whose arg `graph` is true, over the `superstep` spans
that carry the arg; None where none does (a program that records no
such arg)."""


def read(trace):
    flags = [e["args"]["graph"] for r in trace.requests for e in r["spans"]
             if e["name"] == "superstep" and "graph" in e.get("args", {})]
    if not flags:
        return None
    return 100.0 * sum(bool(f) for f in flags) / len(flags)
