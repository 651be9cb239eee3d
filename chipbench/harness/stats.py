"""Percentiles of the benchmark's samples.

`percentile` is a copy of `repro_torch.serve.stats_util.percentile`
(nearest rank), kept here so that the program cannot move the yardstick.
"""

from __future__ import annotations

__all__ = ["percentile"]


def percentile(xs, q):
    """Nearest-rank percentile over a small sample (q in [0, 100])."""
    xs = sorted(xs)
    if not xs:
        return 0.0
    i = min(int(round(q / 100 * (len(xs) - 1))), len(xs) - 1)
    return xs[i]
