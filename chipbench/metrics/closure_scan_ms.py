"""Host milliseconds per query in the `closure.scan` spans inside
`reconstruct`: the host's scan of each chunk's closure mask for the
items of every closure."""

from chipbench.harness.spans import per_query_ms


def read(trace):
    return per_query_ms(trace, "closure.scan")
