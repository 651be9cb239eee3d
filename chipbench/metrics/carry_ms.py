"""Host milliseconds per query in the `carry` span inside `dispatch`: the
pass's carry allocated on the device and the dealt stacks uploaded."""

from chipbench.harness.spans import per_query_ms


def read(trace):
    return per_query_ms(trace, "carry")
