"""TestStatistic — the pluggable hypothesis-test seam of the miner.

A copy of `repro.stats.base`, with the device P-value in torch.  Everything
the engine and the LAMP staging need from a test statistic is four
functions:

  pvalue(x, n, N, N_pos)            exact host P-value (numpy, float64) —
                                    drives ResultSet's reported values
  pvalue_device(x, n, N, N_pos,     batched device P-value (torch, float32)
                k_max=...)          — the engine's in-superstep emission
                                    test; k_max is a static bound on N_pos
                                    for statistics that sum over it
  min_attainable_pvalue(x, N,       Tarone's f(x): a lower bound on the
                        N_pos)      P-value of ANY pattern with support x
  count_thresholds(N, N_pos, alpha) thr[lam] = alpha / f(lam-1), the integer
                                    support-increase table (monotone
                                    non-decreasing on [1, N_pos+1])

Statistics register by name in `STATISTICS`.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np

__all__ = [
    "EPS32",
    "STATISTICS",
    "TestStatistic",
    "gate_rtol",
    "get_statistic",
    "register_statistic",
    "thresholds_from_bound",
]


#: float32 unit roundoff
EPS32 = float(np.finfo(np.float32).eps)


def gate_rtol(N: int) -> float:
    """Twice the float32 log-space error that tests/test_torch_oracles.py
    holds the device P-values to, 4 EPS32 log Gamma(N + 1), plus one
    rounding of the gate to float32: 2 * 4 EPS32 log Gamma(N + 1) + EPS32.

    Two float32 tests, each within the oracle bound of the exact value, can
    decide a record differently only when its float64 P-value lies within
    this (relative, and log-space) distance of the gate; one float32 test
    gated at delta * exp(gate_rtol(N)) emits every record of exact P-value
    <= delta.  0.37% of the gate at N = 697, 10.3% at N = 12,773.

    It holds for both statistics.  Fisher's device test sums log C terms of
    magnitude up to log Gamma(N + 1) in float32, each `lgamma` within a few
    ulps.  Chi2's log p is about -T / 2 in the tail, and T <= N, so the
    float32 rounding of T's products moves log p by a few EPS32 N, below
    the EPS32 log Gamma(N + 1) scale; tests/test_torch_oracles.py holds
    both statistics' device P-values to 4 EPS32 log Gamma(N + 1).
    """
    from scipy.special import gammaln  # host-side only

    return 2 * 4 * EPS32 * float(gammaln(int(N) + 1)) + EPS32


class TestStatistic(ABC):
    """One hypothesis test over a 2x2 margin (x, n, N, N_pos)."""

    #: registry key
    name: str = ""

    @abstractmethod
    def pvalue(self, x, n, N, N_pos) -> np.ndarray:
        """Exact one-sided (enrichment) P-value, host float64, vectorized
        over same-shape x (total support) and n (positive support)."""

    @abstractmethod
    def pvalue_device(self, x, n, N, N_pos, *, k_max: int | None = None):
        """Batched device P-value (torch float32) of 1-D tensors x, n."""

    @abstractmethod
    def min_attainable_pvalue(self, x, N, N_pos) -> np.ndarray:
        """Tarone bound f(x): lower bound on pvalue(x, n) over all n."""

    @abstractmethod
    def count_thresholds(self, N, N_pos, alpha) -> np.ndarray:
        """thr[lam] = alpha / f(lam-1) for lam = 0..N+1 (thr[0] unused),
        monotone non-decreasing on [1, N_pos+1], +inf past the cap."""

    def __repr__(self) -> str:
        return f"<TestStatistic {self.name!r}>"


def thresholds_from_bound(f, N: int, N_pos: int, alpha: float) -> np.ndarray:
    """Generic count_thresholds: alpha / f(lam-1), frozen past N_pos + 1."""
    lam = np.arange(N + 2)
    fx = np.asarray(f(np.maximum(lam - 1, 0)), dtype=np.float64)
    thr = alpha / np.maximum(fx, 1e-300)
    cap = min(N_pos + 1, N + 1)
    thr[cap + 1:] = np.inf
    return thr


#: name -> TestStatistic instance
STATISTICS: dict[str, TestStatistic] = {}


def register_statistic(stat: TestStatistic) -> TestStatistic:
    """Register (or replace) a statistic under `stat.name`."""
    if not stat.name:
        raise ValueError("TestStatistic.name must be a non-empty string")
    STATISTICS[stat.name] = stat
    return stat


def get_statistic(name: str) -> TestStatistic:
    """Resolve a registered statistic by name (actionable on typos)."""
    try:
        return STATISTICS[name]
    except KeyError:
        raise ValueError(
            f"unknown test statistic {name!r}; registered statistics: "
            f"{sorted(STATISTICS)}"
        ) from None
