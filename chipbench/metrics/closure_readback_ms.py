"""Host milliseconds per query in the `closure.readback` spans inside
`reconstruct`: each chunk's [records, items] closure mask copied to the
host, waiting for the chunk's count first."""

from chipbench.harness.spans import per_query_ms


def read(trace):
    return per_query_ms(trace, "closure.readback")
