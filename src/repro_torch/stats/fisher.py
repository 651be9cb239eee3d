"""Exact one-sided Fisher's exact test and Tarone's minimum-attainable P-value bound.

Counterpart of `repro.stats.fisher` (paper §3.1-3.2):

  P(I) = sum_{n_i = n(I)}^{min(x(I), N_pos)}  C(N_pos, n_i) C(N - N_pos, x - n_i) / C(N, x)

  f(x) = C(N_pos, n*) C(N - N_pos, x - n*) / C(N, x),  n* = min(x, N_pos)

The host float64 functions are copies of the JAX package's (numpy/scipy),
so every reported P-value is bit-identical.  The device P-value is torch
float32 with `torch.lgamma`, in the JAX version's order of operations; its
`lgamma` differs from JAX's `gammaln` in the last bits, which can move an
emission decision only for a P-value within float32 error of the gate.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import TestStatistic, register_statistic

__all__ = [
    "FisherExact",
    "log_comb",
    "fisher_pvalue",
    "min_attainable_pvalue",
    "lamp_count_thresholds",
    "fisher_pvalue_torch",
]


# --------------------------------------------------------------------------- numpy
def log_comb(n, k):
    """log C(n, k) with -inf for invalid k (k<0 or k>n). Vectorized."""
    n = np.asarray(n, dtype=np.float64)
    k = np.asarray(k, dtype=np.float64)
    from scipy.special import gammaln  # host-side only

    valid = (k >= 0) & (k <= n)
    kk = np.where(valid, k, 0.0)
    out = gammaln(n + 1) - gammaln(kk + 1) - gammaln(n - kk + 1)
    return np.where(valid, out, -np.inf)


def fisher_pvalue(x, n, N, N_pos):
    """One-sided (enrichment) Fisher exact P-value.

    x: total support of the itemset; n: support within positives.
    Returns P[#positives >= n | margins] under the hypergeometric null.
    Vectorized over x, n (same shape).
    """
    x = np.atleast_1d(np.asarray(x, dtype=np.int64))
    n = np.atleast_1d(np.asarray(n, dtype=np.int64))
    hi = np.minimum(x, N_pos)  # [B]
    max_hi = int(hi.max()) if hi.size else 0
    ni = np.arange(max_hi + 1)[None, :]  # [1, K]
    mask = (ni >= n[:, None]) & (ni <= hi[:, None])
    logp = (
        log_comb(N_pos, ni)
        + log_comb(N - N_pos, x[:, None] - ni)
        - log_comb(N, x)[:, None]
    )
    logp = np.where(mask, logp, -np.inf)
    m = np.max(logp, axis=1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    p = np.exp(m[:, 0]) * np.sum(np.exp(logp - m), axis=1)
    return np.clip(p, 0.0, 1.0)


def min_attainable_pvalue(x, N, N_pos):
    """Tarone bound f(x): smallest achievable P-value for an itemset of support x."""
    x = np.asarray(x, dtype=np.int64)
    n_star = np.minimum(x, N_pos)
    logf = (
        log_comb(N_pos, n_star)
        + log_comb(N - N_pos, x - n_star)
        - log_comb(N, x)
    )
    return np.exp(np.clip(logf, -745.0, 0.0))


def lamp_count_thresholds(N, N_pos, alpha):
    """thr[lam] = alpha / f(lam-1) for lam = 0..N+1 (thr[0] unused),
    frozen past N_pos + 1 (f is no longer monotone there)."""
    lam = np.arange(N + 2)
    f = min_attainable_pvalue(np.maximum(lam - 1, 0), N, N_pos)
    thr = alpha / np.maximum(f, 1e-300)
    cap = min(N_pos + 1, N + 1)
    thr[cap + 1 :] = np.inf
    return thr


# --------------------------------------------------------------------------- torch
def _log_comb_torch(n: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    valid = (k >= 0) & (k <= n)
    kk = torch.where(valid, k, torch.zeros_like(k))
    out = torch.lgamma(n + 1) - torch.lgamma(kk + 1) - torch.lgamma(n - kk + 1)
    return torch.where(valid, out, torch.full_like(out, -torch.inf))


def fisher_pvalue_torch(x: torch.Tensor, n: torch.Tensor, N, N_pos,
                        k_max: int | None = None) -> torch.Tensor:
    """Batched one-sided Fisher exact P-value on the device (float32 log-space).

    x, n: int tensors [B]; N, N_pos: ints.  The summation axis runs over
    0..k_max (default N_pos); terms past the true N_pos are masked by
    hi = min(x, N_pos), so the value does not depend on k_max.
    """
    dev = x.device
    f32 = torch.float32
    ni_hi = int(N_pos) if k_max is None else int(k_max)
    ni = torch.arange(ni_hi + 1, device=dev, dtype=torch.int32)[None, :]
    x32 = x.to(torch.int32)
    n32 = n.to(torch.int32)
    hi = torch.clamp(x32, max=int(N_pos))[:, None]
    mask = (ni >= n32[:, None]) & (ni <= hi)
    npos_t = torch.tensor(float(N_pos), dtype=f32, device=dev)
    nneg_t = torch.tensor(float(N - N_pos), dtype=f32, device=dev)
    n_t = torch.tensor(float(N), dtype=f32, device=dev)
    xf = x32.to(f32)
    logp = (
        _log_comb_torch(npos_t, ni.to(f32))
        + _log_comb_torch(nneg_t, (x32[:, None] - ni).to(f32))
        - _log_comb_torch(n_t, xf)[:, None]
    )
    logp = torch.where(mask, logp, torch.full_like(logp, -torch.inf))
    m = torch.amax(logp, dim=1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(m[:, 0]) * torch.sum(torch.exp(logp - m), dim=1)
    return torch.clamp(p, 0.0, 1.0)


# ------------------------------------------------------------ TestStatistic
class FisherExact(TestStatistic):
    """Fisher's exact test as a registered `TestStatistic` ("fisher")."""

    name = "fisher"

    def pvalue(self, x, n, N, N_pos):
        return fisher_pvalue(x, n, N, N_pos)

    def pvalue_device(self, x, n, N, N_pos, *, k_max: int | None = None):
        return fisher_pvalue_torch(x, n, N, N_pos, k_max=k_max)

    def min_attainable_pvalue(self, x, N, N_pos):
        return min_attainable_pvalue(x, N, N_pos)

    def count_thresholds(self, N, N_pos, alpha):
        return lamp_count_thresholds(N, N_pos, alpha)


register_statistic(FisherExact())
