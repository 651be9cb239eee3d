"""Share of the profiled stretch of back-to-back queries in which no
activity ran on the device (the union of its activities' intervals)."""


def read(trace):
    dev = trace.device
    if trace.driver != "session" or dev is None or not dev.get("busy_s"):
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
