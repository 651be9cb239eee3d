"""One-sided continuity-corrected chi-square test as a `TestStatistic`.

Counterpart of `repro.stats.chi2`.  For the 2x2 table of a pattern with
total support x and positive support n in a cohort of N transactions
(N_pos positives),

    a = n            b = x - n
    c = N_pos - n    d = N - N_pos - x + n

the Yates continuity-corrected statistic is

    T = N * (max(|n*N - x*N_pos| - N/2, 0))^2 / (x (N-x) N_pos (N-N_pos))

and the one-sided (enrichment) upper-bound P-value is the normal tail at
the *signed* root,  p = P(Z >= sign(n*N - x*N_pos) * sqrt(T)), evaluated in
log space (`log_ndtr`) and exponentiated with the clips the Fisher test
uses (-745 host / -87 device).  Degenerate margins zero the denominator;
T is 0 there, giving the null p = 0.5.

The host float64 side is the JAX package's code (numpy and
`scipy.special.log_ndtr`), so every reported P-value is bit-identical.
The device side is torch float32 with `torch.special.log_ndtr`, in the JAX
version's order of operations; it differs from `jax.scipy.special.log_ndtr`
in the last bits, which can move an emission decision only for a P-value
within float32 error of the gate.

Tarone bound: T grows with |n*N - x*N_pos| for fixed x, so the
per-support minimum is attained at n* = min(x, N_pos); that raw minimum is
not monotone in x under the continuity correction, so
`min_attainable_pvalue` returns its running-minimum envelope over x (a
valid lower bound for every support), which makes `count_thresholds`
monotone by construction.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import TestStatistic, register_statistic, thresholds_from_bound
from .fisher import as_float32

__all__ = ["ChiSquared", "chi2_pvalue", "chi2_pvalue_torch"]


def _signed_root_np(x, n, N, N_pos):
    """z = sign(n*N - x*N_pos) * sqrt(T) for the Yates-corrected T."""
    num = n * N - x * N_pos
    corr = np.maximum(np.abs(num) - N / 2.0, 0.0)
    denom = x * (N - x) * N_pos * (N - N_pos)
    t = np.where(denom > 0, N * corr * corr / np.maximum(denom, 1.0), 0.0)
    return np.sign(num) * np.sqrt(t)


def chi2_pvalue(x, n, N, N_pos):
    """One-sided continuity-corrected chi-square P-value (host float64)."""
    from scipy.special import log_ndtr  # host-side only

    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    n = np.atleast_1d(np.asarray(n, dtype=np.float64))
    z = _signed_root_np(x, n, float(N), float(N_pos))
    # P(Z >= z) = ndtr(-z), in log space to survive the deep tail
    return np.exp(np.clip(log_ndtr(-z), -745.0, 0.0))


def chi2_pvalue_torch(x: torch.Tensor, n: torch.Tensor, N, N_pos,
                      k_max: int | None = None) -> torch.Tensor:
    """Batched device P-value (float32) of int tensors x, n [B]; N, N_pos
    ints or 0-d integer device tensors.  Closed form — `k_max` (the static
    N_pos bound Fisher's summation axis needs) is accepted and ignored, so
    both statistics share one engine call signature."""
    del k_max
    f32 = torch.float32
    dev = x.device
    x = x.to(f32)
    n = n.to(f32)
    N = as_float32(N, dev)
    N_pos = as_float32(N_pos, dev)
    num = n * N - x * N_pos
    corr = torch.clamp(torch.abs(num) - N / 2.0, min=0.0)
    denom = x * (N - x) * N_pos * (N - N_pos)
    t = torch.where(denom > 0, N * corr * corr / torch.clamp(denom, min=1.0),
                    torch.zeros_like(denom))
    z = torch.sign(num) * torch.sqrt(t)
    return torch.exp(torch.clamp(torch.special.log_ndtr(-z), -87.0, 0.0))


class ChiSquared(TestStatistic):
    """Continuity-corrected one-sided chi-square, registered as "chi2"."""

    name = "chi2"

    def pvalue(self, x, n, N, N_pos):
        return chi2_pvalue(x, n, N, N_pos)

    def pvalue_device(self, x, n, N, N_pos, *, k_max: int | None = None):
        return chi2_pvalue_torch(x, n, N, N_pos, k_max=k_max)

    def min_attainable_pvalue(self, x, N, N_pos):
        x = np.atleast_1d(np.asarray(x, dtype=np.int64))
        grid = np.arange(0, int(N) + 1)
        raw = chi2_pvalue(grid, np.minimum(grid, int(N_pos)), N, N_pos)
        env = np.minimum.accumulate(raw)  # monotone non-increasing envelope
        return env[np.clip(x, 0, int(N))]

    def count_thresholds(self, N, N_pos, alpha):
        return thresholds_from_bound(
            lambda xs: self.min_attainable_pvalue(xs, N, N_pos), N, N_pos, alpha
        )


register_statistic(ChiSquared())
