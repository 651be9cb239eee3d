"""LAMP's significant patterns (Terada et al., PNAS 2013), in plain NumPy.

The query: every closed itemset whose one-sided Fisher's exact P-value is
at most delta = alpha / k, where k counts the closed itemsets of support at
least min_sup = lambda - 1, and lambda is the smallest support threshold at
which the closed itemsets of that support or more number no more than
alpha over Tarone's least attainable P-value at lambda - 1.  P- and
q-values are float64 (`dtype=np.float32` gives the control of the check).
"""

from __future__ import annotations

import math

import numpy as np

from .closed import closed_itemsets

__all__ = ["fisher_pvalues", "lamp_query", "tarone_thresholds"]


def _log_factorials(n: int, dtype) -> np.ndarray:
    return np.array([math.lgamma(j + 1) for j in range(n + 1)], dtype=np.float64).astype(dtype)


def _log_comb(lf: np.ndarray, a, b):
    return lf[a] - lf[b] - lf[a - b]


def tarone_thresholds(n: int, n_pos: int, alpha: float, dtype=np.float64) -> np.ndarray:
    """thr[lam] = alpha / f(lam - 1) for lam = 0..n+1, where f(x) is the
    least P-value an itemset of support x can reach; infinite past
    n_pos + 1, where f stops falling."""
    lf = _log_factorials(n, dtype)
    thr = np.full(n + 2, np.inf, dtype=dtype)
    for lam in range(n + 2):
        if lam > min(n_pos + 1, n + 1):
            break
        x = max(lam - 1, 0)
        best = min(x, n_pos)
        log_f = (_log_comb(lf, n_pos, best) + _log_comb(lf, n - n_pos, x - best)
                 - _log_comb(lf, n, x))
        thr[lam] = dtype(alpha) / np.exp(dtype(log_f))
    return thr


def fisher_pvalues(x: np.ndarray, k: np.ndarray, n: int, n_pos: int,
                   dtype=np.float64) -> np.ndarray:
    """P[positives >= k | support x] under the hypergeometric null, for
    each (x, k) pair, summed in log space in `dtype`."""
    lf = _log_factorials(n, dtype)
    out = np.empty(len(x), dtype=dtype)
    memo: dict[tuple[int, int], float] = {}
    for i, (xi, ki) in enumerate(zip(np.asarray(x).tolist(), np.asarray(k).tolist())):
        key = (xi, ki)
        if key not in memo:
            j = np.arange(ki, min(xi, n_pos) + 1)
            terms = (_log_comb(lf, n_pos, j) + _log_comb(lf, n - n_pos, xi - j)
                     - _log_comb(lf, n, xi)).astype(dtype)
            top = terms.max()
            memo[key] = dtype(min(dtype(1), np.exp(top) * np.exp(terms - top).sum(dtype=dtype)))
        out[i] = memo[key]
    return out


def lamp_query(db: np.ndarray, labels: np.ndarray, alpha: float,
               dtype=np.float64) -> dict:
    """The answer of one LAMP query on `db` ([N, M] bool) and `labels`."""
    db = np.asarray(db, dtype=bool)
    labels = np.asarray(labels, dtype=bool)
    n = db.shape[0]
    n_pos = int(labels.sum())
    thr = tarone_thresholds(n, n_pos, alpha, dtype)
    tally = np.zeros(n + 2, dtype=np.int64)
    lam = [1]

    def raise_threshold(sups: np.ndarray) -> int:
        np.add.at(tally, sups, 1)
        while lam[0] <= n and tally[lam[0]:].sum() > thr[lam[0]]:
            lam[0] += 1
        return lam[0]

    closed_itemsets(db, labels, 1, raise_threshold=raise_threshold)
    lambda_final = lam[0]
    min_sup = max(lambda_final - 1, 1)
    found = closed_itemsets(db, labels, min_sup)
    k = len(found)
    delta = alpha / max(k, 1)
    sups = np.array([f[1] for f in found], dtype=np.int64)
    pos = np.array([f[2] for f in found], dtype=np.int64)
    pv = fisher_pvalues(sups, pos, n, n_pos, dtype)
    patterns = [(items, sup, psup, float(p), float(min(1.0, float(p) * max(k, 1))))
                for (items, sup, psup), p in zip(found, pv) if p <= delta]
    return dict(lambda_final=lambda_final, min_sup=min_sup, correction_factor=k,
                n_significant=len(patterns), patterns=patterns)


def closed_query(db: np.ndarray, labels: np.ndarray, min_sup: int,
                 counts: str = "exact") -> dict:
    """The answer of one closed-frequent query: every closed itemset of
    support min_sup or more, with its support and positive support."""
    found = closed_itemsets(db, labels, min_sup, counts=counts)
    return dict(lambda_final=min_sup, min_sup=min_sup, correction_factor=1,
                n_significant=len(found),
                patterns=[(items, sup, psup, math.nan, math.nan) for items, sup, psup in found])
