"""Latency statistics helpers shared by the serving layer and launchers
(counterpart of `repro.serve.stats_util`).

Moved out of `launch.mine_serve` so the load generator
(`serve.loadgen`), the serving benchmark (`benchmarks.bench_serving`)
and the CLI client all consume one implementation instead of drifting
copies.
"""

from __future__ import annotations

__all__ = ["latency_histogram", "latency_summary", "percentile"]


def percentile(xs, q):
    """Nearest-rank percentile over a small sample (q in [0, 100])."""
    xs = sorted(xs)
    if not xs:
        return 0.0
    i = min(int(round(q / 100 * (len(xs) - 1))), len(xs) - 1)
    return xs[i]


def latency_histogram(lat_s, width=40) -> str:
    """Log2-bucket text histogram over milliseconds."""
    if not lat_s:
        return "(no samples)"
    ms = [x * 1e3 for x in lat_s]
    lo = min(ms)
    edge = 1.0
    while edge > lo:
        edge /= 2
    buckets: dict[float, int] = {}
    for x in ms:
        e = edge
        while e * 2 <= x:
            e *= 2
        buckets[e] = buckets.get(e, 0) + 1
    peak = max(buckets.values())
    lines = []
    for e in sorted(buckets):
        n = buckets[e]
        bar = "#" * max(1, round(width * n / peak))
        lines.append(f"  [{e:9.1f}ms, {e * 2:9.1f}ms)  {n:4d}  {bar}")
    return "\n".join(lines)


def latency_summary(lat_s, *, prefix: str = "") -> dict:
    """The standard percentile block every serving report carries."""
    if not lat_s:
        return {f"{prefix}n": 0}
    return {
        f"{prefix}n": len(lat_s),
        f"{prefix}mean_s": round(sum(lat_s) / len(lat_s), 4),
        f"{prefix}p50_s": round(percentile(lat_s, 50), 4),
        f"{prefix}p90_s": round(percentile(lat_s, 90), 4),
        f"{prefix}p99_s": round(percentile(lat_s, 99), 4),
        f"{prefix}max_s": round(max(lat_s), 4),
    }
