"""Device activities (kernels, copies, sets) in the profiled stretch over
the supersteps of the requests run in it."""


def read(trace):
    dev = trace.device
    if dev is None or not dev.get("supersteps") or not dev["intervals"]:
        return None
    return len(dev["intervals"]) / dev["supersteps"]
