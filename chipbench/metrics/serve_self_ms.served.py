"""Host milliseconds per served request outside the query: each
`serve.request` span (a worker's device scope, the query, the result's
packaging and resolution) less what the same thread's spans inside it
cover, as `tracectx.span_self_us` reckons it."""

import bisect
from collections import defaultdict

from chipbench.harness.tracectx import span_self_us


def read(trace):
    if trace.driver != "served":
        return None
    by_thread = defaultdict(list)
    for name, lo, hi, tid in trace.host_spans:
        by_thread[tid].append({"name": name, "ts": lo, "dur": hi - lo, "tid": tid})
    total_us, n = 0.0, 0
    for spans in by_thread.values():
        spans.sort(key=lambda s: s["ts"])
        starts = [s["ts"] for s in spans]
        for s in spans:
            if s["name"] != "serve.request":
                continue
            # the spans that start inside this one, itself first
            i = bisect.bisect_left(starts, s["ts"])
            j = bisect.bisect_left(starts, s["ts"] + s["dur"])
            total_us += span_self_us(spans[i:j], "serve.request")
            n += 1
    return total_us / n / 1e3 if n else None
