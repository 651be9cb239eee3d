"""Share of the dense candidate pass's rows that hold a node: the nodes the
passes popped over their supersteps times the rows each superstep scans
(P x expand batch), from the `dispatch` spans' args `popped`,
`supersteps` and `rows`; None where no span carries them (a program that
records no such args)."""


def read(trace):
    spans = [e["args"] for r in trace.requests for e in r["spans"]
             if e["name"] == "dispatch" and "popped" in e.get("args", {})]
    rows = sum(a["supersteps"] * a["rows"] for a in spans)
    if not rows:
        return None
    return 100.0 * sum(a["popped"] for a in spans) / rows
