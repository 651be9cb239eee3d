"""Share of the profiled stretch, while every session of the fleet serves,
in which no activity ran on the device (the union over the workers'
streams)."""


def read(trace):
    dev = trace.device
    if trace.driver != "served" or dev is None or not dev.get("busy_s"):
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
