"""Host milliseconds per query of the float64 decision of the test pass's
emitted records: the `refilter` span.  None where the program records no
such span."""

from chipbench.harness.spans import per_query_ms


def read(trace):
    return per_query_ms(trace, "refilter")
