"""Host milliseconds per superstep blocked on the device: the
`census.read` span, the loop's one read of the hunger census, which waits
for the superstep's work queued before it."""

from chipbench.harness.spans import per_superstep_ms


def read(trace):
    return per_superstep_ms(trace, "census.read")
