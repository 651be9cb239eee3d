"""Host milliseconds per query of LAMP's first pass, the lambda search: the
`phase:lamp1` span (Tarone's bound raised over the support histogram)."""

from chipbench.harness.spans import per_query_ms


def read(trace):
    return per_query_ms(trace, "phase:lamp1")
