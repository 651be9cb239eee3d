"""Host milliseconds per query of LAMP's test pass: the `phase:test` span
(the closed sets at min_sup walked again, each tested on the device)."""

from chipbench.harness.spans import per_query_ms


def read(trace):
    return per_query_ms(trace, "phase:test")
