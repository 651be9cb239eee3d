"""Device activity from `torch.profiler`, the kernel's bound, the card's peaks.

`busy_union_s` is a copy of `chip_smoke.py::_busy_union_s` (over
intervals read once by `device_intervals`, with `_device_times`'s rule for
leaving out host annotations) and `bound_s` of `chip_smoke.py::_bound` (in
seconds), kept here so that the program cannot move the yardstick.  The peaks are NVIDIA's data sheet for the H100 SXM, dense:
3.35 TB/s of HBM3 and 1,979 TOP/s int8 on the tensor cores.  The support
count's AND + popcount runs on the binary MMA, whose rate is not published;
the int8 rate stands in for it, each bit counted as one int8
multiply-add.  With it the bytes term is the larger at every shape the
cells launch.
"""

from __future__ import annotations

import bisect
import math
from collections import defaultdict

__all__ = ["HBM_BYTES_PER_S", "INT8_OPS_PER_S", "bound_s", "busy_union_s",
           "device_intervals", "host_events", "idle_gaps",
           "top_device_ops"]

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15


def bound_s(b: int, m: int, w: int, launches: int = 1) -> tuple[float, str]:
    """(seconds, "bytes" | "operations"): the least time of `launches`
    launches of S[r, j] = sum_w popcount(occ[r, w] & db[j, w]) over `b`
    rows of occ in all, against db [m, w] words: each launch reads db once,
    and each row is read and its S row written once.  Over several
    launches it is the larger of the summed terms, which equals the sum of
    each launch's bound where one term wins at every launch (both grow
    with the rows alike) and is never above it."""
    ops_s = 2 * b * m * 32 * w / INT8_OPS_PER_S
    bytes_s = (launches * m * w + b * w + b * m) * 4 / HBM_BYTES_PER_S
    return max(ops_s, bytes_s), ("operations" if ops_s > bytes_s else "bytes")


def _is_annotation(e, span_names=()) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or e.name in span_names


def device_intervals(prof, span_names=()) -> list[tuple[str, float, float]]:
    """[(name, start us, end us)] of every CUDA activity of a profile
    (kernels, copies, sets), times from the profile's start, host
    annotations left out."""
    from torch.autograd import DeviceType

    return sorted(((e.name, float(e.time_range.start), float(e.time_range.end))
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not _is_annotation(e, span_names)),
                  key=lambda t: t[1])


def host_events(prof) -> list[tuple[str, float, float, int]]:
    """[(name, start us, end us, thread)] of the host's events of a profile
    (operators, runtime calls and `record_function` spans)."""
    from torch.autograd import DeviceType

    return sorted(((e.name, float(e.time_range.start), float(e.time_range.end),
                    int(getattr(e, "thread", 0)))
                   for e in prof.events() if e.device_type == DeviceType.CPU),
                  key=lambda t: t[1])


def busy_union_s(intervals, until_s: float) -> float | None:
    """Seconds of a profile's first `until_s` in which at least one kernel
    ran on the card: the union of the CUDA activities' intervals (times
    from the profile's start), since kernels of two workers' streams may
    overlap; None when the profile holds no device activity."""
    until_us = until_s * 1e6
    spans = sorted((max(lo, 0.0), min(hi, until_us)) for _, lo, hi in intervals)
    spans = [(lo, hi) for lo, hi in spans if hi > lo]
    if not spans:
        return None
    busy, reach = 0.0, -math.inf
    for lo, hi in spans:
        if hi > reach:
            busy += hi - max(lo, reach)
            reach = hi
    return busy / 1e6


def top_device_ops(intervals, k: int = 10, width: int = 160) -> list[list]:
    """The k device operations that took most time: [[name, seconds]],
    names cut to `width` characters."""
    total: dict[str, float] = defaultdict(float)
    for name, lo, hi in intervals:
        total[name[:width]] += (hi - lo) / 1e6
    return [[n, s] for n, s in sorted(total.items(), key=lambda t: -t[1])[:k]]


def _gaps(intervals, until_us: float):
    reach = 0.0
    for _, lo, hi in sorted(intervals, key=lambda t: t[1]):
        if lo > reach:
            yield reach, min(lo, until_us)
        reach = max(reach, hi)
        if reach >= until_us:
            return
    if reach < until_us:
        yield reach, until_us


def idle_gaps(intervals, ops, spans, until_s: float, k: int = 10) -> list[list]:
    """Seconds in which the device was idle, by what the host was doing
    then: at each gap's middle, the innermost span of each thread
    (`spans`: [(name, start us, end us, thread)], joined by " | ") and the
    innermost host event of the profile there (`ops`, same form; "python"
    when the host was in none).  The k largest: [[name, seconds]]."""
    ops = sorted(ops, key=lambda h: h[1])
    op_starts = [h[1] for h in ops]
    threads = sorted({s[3] for s in spans})

    def innermost_op(t):
        i = bisect.bisect_right(op_starts, t) - 1
        for j in range(i, max(i - 64, -1), -1):
            if ops[j][1] <= t < ops[j][2]:
                return ops[j][0]
        return "python"

    total: dict[str, float] = defaultdict(float)
    for lo, hi in _gaps(intervals, until_s * 1e6):
        if hi <= lo:
            continue
        mid = (lo + hi) / 2
        names = []
        for t in threads:
            inside = [s for s in spans if s[3] == t and s[1] <= mid < s[2]]
            if inside:
                names.append(max(inside, key=lambda s: (s[1], -s[2]))[0])
        where = " | ".join(sorted(set(names))) or "outside the session"
        total[f"{where} > {innermost_op(mid)}"] += (hi - lo) / 1e6
    return [[n, s] for n, s in sorted(total.items(), key=lambda t: -t[1])[:k]]
