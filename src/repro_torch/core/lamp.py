"""LAMP — limitless-arity multiple testing procedure (paper §3) — host reference
(a copy of `repro.core.lamp`, numpy only).

Three phases (paper §3.3):

  Phase 1  support-increase: a single LCM run with a dynamically rising support
           threshold lambda.  Maintain bucket counts cnt[s] = #closed sets with
           support exactly s found so far; advance lambda while

               CS(lambda) > alpha / f(lambda - 1)          (Eq. 3.1 rearranged)

           where CS(lambda) = sum_{s >= lambda} cnt[s].  Subtrees with support
           < lambda are pruned — they can only touch buckets whose condition is
           already (permanently) satisfied.  Terminates with lambda_final;
           min_sup = lambda_final - 1.

  Phase 2  count k = CS(min_sup) exactly with a fresh frequent-closed mining at
           min_sup.  delta = alpha / k is the corrected significance level.

  Phase 3  Fisher-exact test every closed set with support >= min_sup against
           delta; emit the significant ones.

The engine (core/engine.py) runs the same schedule with the bucket histogram
summed over the miners every superstep (paper §4.4: the lambda broadcast may
lag without affecting correctness — a stale, smaller lambda only prunes less).

This module is the sequential oracle used by tests and small benchmarks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.stats import get_statistic

from .lcm import MiningStats, lcm_closed

__all__ = ["LampResult", "SignificantPattern", "lamp_phase1", "lamp", "Phase1State"]


@dataclass
class SignificantPattern:
    items: frozenset
    support: int
    pos_support: int
    pvalue: float


@dataclass
class LampResult:
    n_transactions: int
    n_pos: int
    alpha: float
    lambda_final: int  # lambda at phase-1 termination
    min_sup: int  # = lambda_final - 1 (paper: "smaller than the last lambda by 1")
    correction_factor: int  # k = CS(min_sup) from phase 2
    delta: float  # alpha / k
    significant: list[SignificantPattern]
    phase1_stats: MiningStats | None = None
    phase2_stats: MiningStats | None = None


class Phase1State:
    """Support-increase bookkeeping shared by the oracle and the engine tests.

    `statistic` names the registered `repro_torch.stats.TestStatistic` whose
    Tarone bound drives the thresholds (default: Fisher, the paper's test).
    """

    def __init__(self, n_transactions: int, n_pos: int, alpha: float,
                 statistic: str = "fisher"):
        self.N = n_transactions
        self.thr = get_statistic(statistic).count_thresholds(
            n_transactions, n_pos, alpha
        )
        self.cnt = np.zeros(n_transactions + 2, dtype=np.int64)
        self.lam = 1

    def cs(self, lam: int) -> int:
        return int(self.cnt[lam:].sum())

    def observe(self, support: int) -> int:
        """Count one closed itemset; advance lambda per Eq 3.1; return new lambda."""
        if support >= self.lam:
            self.cnt[support] += 1
            while self.lam <= self.N and self.cs(self.lam) > self.thr[self.lam]:
                self.lam += 1
        return self.lam


def lamp_phase1(db_bool: np.ndarray, n_pos: int, alpha: float,
                statistic: str = "fisher"):
    """Run phase 1; returns (lambda_final, min_sup, stats)."""
    db_bool = np.asarray(db_bool, dtype=bool)
    n = db_bool.shape[0]
    state = Phase1State(n, n_pos, alpha, statistic)
    _, stats = lcm_closed(db_bool, min_sup=1, dynamic_min_sup=state.observe)
    lam_final = state.lam
    return lam_final, max(lam_final - 1, 1), stats


def lamp(db_bool: np.ndarray, labels: np.ndarray, alpha: float = 0.05,
         statistic: str = "fisher") -> LampResult:
    """Full three-phase LAMP on a labelled transaction database.

    db_bool: [N, M] bool; labels: [N] bool (positive class); `statistic`
    selects the registered test (Tarone bound AND phase-3 extraction).
    """
    db_bool = np.asarray(db_bool, dtype=bool)
    labels = np.asarray(labels, dtype=bool)
    n, m = db_bool.shape
    n_pos = int(labels.sum())
    stat = get_statistic(statistic)

    # ---- phase 1: find min_sup by support increase
    lam_final, min_sup, st1 = lamp_phase1(db_bool, n_pos, alpha, statistic)

    # ---- phase 2: exact closed-set count at min_sup (+ collect for phase 3)
    from .bitmap import unpack_occ  # local import to avoid cycle at module load

    collected: list[tuple[frozenset, int, int]] = []
    pos_mask = labels

    def on_closed(occ, sup, clo_items):
        occ_bool = unpack_occ(occ, n)
        pos_sup = int(np.count_nonzero(occ_bool & pos_mask))
        collected.append((frozenset(clo_items.tolist()), sup, pos_sup))

    _, st2 = lcm_closed(db_bool, min_sup=min_sup, on_closed=on_closed)
    k = len(collected)
    delta = alpha / max(k, 1)

    # ---- phase 3: exact extraction (paper: ~10 ms; merged sweep here)
    significant = []
    if k:
        sups = np.array([c[1] for c in collected])
        pos_sups = np.array([c[2] for c in collected])
        pvals = stat.pvalue(sups, pos_sups, n, n_pos)
        for (items, sup, psup), p in zip(collected, pvals):
            if p <= delta:
                significant.append(SignificantPattern(items, sup, psup, float(p)))
    significant.sort(key=lambda s: s.pvalue)

    return LampResult(
        n_transactions=n,
        n_pos=n_pos,
        alpha=alpha,
        lambda_final=lam_final,
        min_sup=min_sup,
        correction_factor=k,
        delta=delta,
        significant=significant,
        phase1_stats=st1,
        phase2_stats=st2,
    )
