"""Host milliseconds per query in the `outputs` span inside `dispatch`:
the pass's outputs (histograms, counters, emitted records) read back to
the host."""

from chipbench.harness.spans import per_query_ms


def read(trace):
    return per_query_ms(trace, "outputs")
