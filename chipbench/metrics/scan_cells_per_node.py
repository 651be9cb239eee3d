"""Item cells the dense candidate pass reads for each node it pops: the
supersteps times the rows times the item columns each superstep scans,
over the nodes popped, from the `dispatch` spans' args `supersteps`,
`rows`, `items` and `popped`; None where no span carries them (a program
that records no such args) or no node was popped."""


def read(trace):
    spans = [e["args"] for r in trace.requests for e in r["spans"]
             if e["name"] == "dispatch" and "popped" in e.get("args", {})]
    popped = sum(a["popped"] for a in spans)
    if not popped:
        return None
    return sum(a["supersteps"] * a["rows"] * a["items"] for a in spans) / popped
