"""Host milliseconds per superstep of the engine's loop, read from the
`superstep` spans themselves (one per iteration), without the carry's
upload and the outputs' read-back that `superstep_ms` spreads over them."""

from chipbench.harness.spans import per_superstep_ms


def read(trace):
    return per_superstep_ms(trace, "superstep")
