"""Host milliseconds per query of LAMP's count pass: the `phase:count` span
(the closed sets at min_sup walked once to count them, the correction
factor)."""

from chipbench.harness.spans import per_query_ms


def read(trace):
    return per_query_ms(trace, "phase:count")
