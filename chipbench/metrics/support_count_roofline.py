"""The support-count kernel's share of its roofline in the profiled stretch:
the least time of the launches' live work over their device time.

The work is reckoned from the rows that hold a node, not from the launch:
EXPAND launches one batch of `expand_rows` rows a superstep, of which only
the nodes popped alive (`PhaseReport.n_nodes`) are live, and every row of a
reconstruction chunk is a record.  Items M and words W are the dataset's
own, not the bucket's padding.  The bound is `harness/profile.py::bound_s`.
None when the profiler saw another number of launches than the kernel's
counter made, or fewer EXPAND-shaped launches than supersteps.
"""

from chipbench.harness.profile import bound_s

#: the CUDA kernel's symbol (`support_count.cu`), in the profiler's names
KERNEL_NAMES = ("support_count_kernel",)


def read(trace):
    dev = trace.device
    if dev is None or not dev.get("launch_shapes"):
        return None
    ours = [(lo, hi) for name, lo, hi in dev["intervals"]
            if any(k in name for k in KERNEL_NAMES)]
    shapes = dev["launch_shapes"]
    launches = sum(shapes.values())
    if not ours or len(ours) != launches:
        return None
    steps, batch = dev["supersteps"], dev["expand_rows"]
    if sum(n for (b, _, _), n in shapes.items() if b == batch) < steps:
        return None
    rows = sum(b * n for (b, _, _), n in shapes.items()) - steps * batch + dev["nodes"]
    bound, _ = bound_s(rows, trace.dims["items"], trace.dims["words"], launches=launches)
    device_s = sum(hi - lo for lo, hi in ours) / 1e6
    return 100.0 * bound / device_s
