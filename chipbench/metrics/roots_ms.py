"""Host milliseconds per query of the root deal: the `roots` span inside
`pack` (the host's depth-1 expansion over every item and the dealt
[P, stack_cap, W] stacks)."""

from chipbench.harness.spans import per_query_ms


def read(trace):
    return per_query_ms(trace, "roots")
