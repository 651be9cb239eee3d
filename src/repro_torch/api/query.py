"""Queries as first-class objects — the mining objectives of one engine
(counterpart of `repro.api.query`).

A `Query` is a frozen description of an objective, executed by
`MinerSession.run(dataset, query)` against the session's warm programs.
Three objectives ship:

  SignificantPatternQuery(alpha, statistic, pipeline)
      Full LAMP staging (lambda search -> correction factor -> corrected
      test) under any registered `repro_torch.stats.TestStatistic`.  The
      default query — `session.mine(...)` is a thin wrapper that builds one.

  ClosedFrequentQuery(min_sup, top_k)
      Every closed itemset with support >= min_sup: a single "test"-mode
      traversal whose emission gate is constant-true (statistic=None).
      Works on unlabelled datasets.

  TopKSignificantQuery(k, statistic)
      Alpha-free: the k individually most significant patterns, by a host
      bisection over the corrected level delta, each probe one "test"
      traversal on the warm session at its Tarone-bound min_sup(delta).

Constructors validate their parameters eagerly so a bad query fails at
build time, not after a traversal.  The code is the JAX package's, line
for line.
"""

from __future__ import annotations

import math
import time
import warnings
from abc import ABC, abstractmethod
from dataclasses import dataclass

import numpy as np

from repro_torch.stats import get_statistic

from .report import MineReport

__all__ = [
    "QUERIES",
    "Query",
    "ClosedFrequentQuery",
    "SignificantPatternQuery",
    "TopKSignificantQuery",
]


class Query(ABC):
    """A frozen mining objective, executable against any MinerSession."""

    @abstractmethod
    def run(self, session, dataset) -> MineReport:
        """Execute on `session` (repro_torch.api.MinerSession) over `dataset`."""

    def _require_labels(self, dataset) -> None:
        if dataset.labels is None:
            raise ValueError(
                f"{type(self).__name__} tests against class labels, but "
                f"dataset {dataset.name!r} has none; construct it with "
                "labels=..., or use ClosedFrequentQuery for unlabelled data"
            )


@dataclass(frozen=True)
class SignificantPatternQuery(Query):
    """All patterns significant at family-wise level alpha (LAMP staging)."""

    alpha: float = 0.05
    statistic: str = "fisher"
    pipeline: str = "three_phase"

    def __post_init__(self):
        if not (isinstance(self.alpha, float) and 0.0 < self.alpha < 1.0):
            raise ValueError(
                f"SignificantPatternQuery.alpha must be a float in (0, 1), "
                f"got {self.alpha!r}"
            )
        get_statistic(self.statistic)  # fail on typos at construction

    def run(self, session, dataset) -> MineReport:
        from .session import PIPELINES

        self._require_labels(dataset)
        try:
            stage = PIPELINES[self.pipeline]
        except KeyError:
            raise ValueError(
                f"unknown pipeline {self.pipeline!r}; available: "
                f"{sorted(PIPELINES)}"
            ) from None
        return stage(session, dataset, self)


@dataclass(frozen=True)
class ClosedFrequentQuery(Query):
    """All closed itemsets with support >= min_sup (top_k largest kept)."""

    min_sup: int
    top_k: int | None = None

    def __post_init__(self):
        if not (isinstance(self.min_sup, int) and self.min_sup >= 1):
            raise ValueError(
                f"ClosedFrequentQuery.min_sup must be an int >= 1, got "
                f"{self.min_sup!r} (support thresholds count transactions)"
            )
        if self.top_k is not None and not (
            isinstance(self.top_k, int) and self.top_k >= 1
        ):
            raise ValueError(
                f"ClosedFrequentQuery.top_k must be None or an int >= 1, "
                f"got {self.top_k!r}"
            )

    def run(self, session, dataset) -> MineReport:
        t0 = time.perf_counter()
        # one traversal: mode "test" with no statistic emits every counted
        # closed set (delta >= 1 keeps the runtime gate wide open)
        ph = session.run_phase(
            dataset, "test", min_sup=self.min_sup, delta=1.0, statistic=None,
        )
        if ph.partial:  # soft deadline: emitted-so-far closed sets, no root
            report = session._partial_mine_report(
                dataset, [ph], pipeline="closed-frequent",
                query_tag="closed-frequent", alpha=float("nan"),
                statistic=None, t0=t0, min_sup=self.min_sup, k=1, lam=self.min_sup,
            )
            if self.top_k is not None:
                report.results.patterns = report.results.patterns[: self.top_k]
            return report
        k = ph.output.sig_count  # device emissions + the host-counted root

        # the root closed set (closure of the empty itemset) never transits
        # the device buffers; append its record host-side so the pattern
        # list matches the count (and the sequential lcm_closed oracle)
        results = session._build_results(
            dataset, ph.output, alpha=float("nan"), min_sup=self.min_sup,
            k=1, delta=float("nan"), filter_host=False, statistic=None,
            records=session._root_record(dataset, ph.output, None,
                                         float("nan"), self.min_sup),
        )
        if self.top_k is not None:
            results.patterns = results.patterns[: self.top_k]
        return MineReport(
            dataset=dataset.name,
            pipeline="closed-frequent",
            alpha=float("nan"),
            lambda_final=self.min_sup,
            min_sup=self.min_sup,
            correction_factor=1,
            delta=float("nan"),
            n_significant=k,
            results=results,
            phases=(ph,),
            wall_s=time.perf_counter() - t0,
            statistic=None,
            query="closed-frequent",  # the QUERIES key, round-trippable
        )


@dataclass(frozen=True)
class TopKSignificantQuery(Query):
    """The k individually most significant patterns, no alpha required.

    Bisects the corrected level delta on the warm session: each probe runs
    one "test" traversal at (delta, min_sup(delta)) — min_sup(delta) is the
    smallest support whose Tarone bound can still reach delta, so probes
    stay pruned — and counts the significant patterns; the bracket closes
    on the smallest probed delta admitting >= k patterns, whose emitted
    records are exactly re-tested on the host and truncated to the k best.
    Only the first probe can build a program; the rest reuse the cached one.

    Patterns with P > 0.5 are never considered (delta is bisected inside
    (0, 0.5]); if fewer than k patterns clear that ceiling, all of them are
    returned (check `report.n_significant`).

    Why bisection rather than one `count2d` histogram pass (which would fix
    the exact k-th delta in a single traversal): on a warm session the
    `test` program is typically already cached by significant-pattern
    queries of the same statistic, so every probe is a warm dispatch at a
    Tarone-pruned min_sup, whereas `count2d` would need a second program
    per (bucket, statistic) and always pay one full min_sup=1-ish
    enumeration.
    """

    k: int
    statistic: str = "fisher"
    max_probes: int = 24

    def __post_init__(self):
        if not (isinstance(self.k, int) and self.k >= 1):
            raise ValueError(
                f"TopKSignificantQuery.k must be an int >= 1, got {self.k!r}"
            )
        if not (isinstance(self.max_probes, int) and self.max_probes >= 1):
            raise ValueError(
                f"TopKSignificantQuery.max_probes must be an int >= 1, got "
                f"{self.max_probes!r}"
            )
        get_statistic(self.statistic)

    def run(self, session, dataset) -> MineReport:
        self._require_labels(dataset)
        t0 = time.perf_counter()
        stat = get_statistic(self.statistic)
        n, n_pos = dataset.n_transactions, dataset.n_pos
        # Tarone bound per support: min_sup(delta) prunes every probe
        f = np.asarray(
            stat.min_attainable_pvalue(np.arange(n + 1), n, n_pos),
            dtype=np.float64,
        )

        phases = []
        # postprocess counts the root closed set host-side when its P-value
        # clears delta (possible for chi2: p_root = 0.5), but the root never
        # rides the emission buffers — exclude it so the bisection counts
        # exactly the emittable patterns it will later truncate to k
        root_p = float(stat.pvalue(n, n_pos, n, n_pos)[0])

        def probe(delta: float):
            reachable = np.flatnonzero(f[1:] <= delta)
            if reachable.size == 0:
                return None, 0
            ph = session.run_phase(
                dataset, "test", min_sup=int(reachable[0]) + 1, delta=delta,
                statistic=self.statistic,
            )
            phases.append(ph)
            if ph.partial:  # soft deadline mid-probe: abort the bisection
                return ph, -1
            return ph, ph.output.sig_count - (1 if root_p <= delta else 0)

        hi = 0.5
        stopped = False
        ph_hi, c_hi = probe(hi)
        if c_hi < 0:  # deadline hit inside the very first probe
            return session._partial_mine_report(
                dataset, phases, pipeline="topk", query_tag="topk",
                alpha=float("nan"), statistic=self.statistic, t0=t0,
                min_sup=1, k=1, delta=hi, lam=0,
            )
        if c_hi >= self.k:
            lo = max(float(f.min()) / 2.0, 1e-290)
            for _ in range(self.max_probes - 1):
                if c_hi == self.k or hi <= lo * (1.0 + 1e-9):
                    break
                mid = math.sqrt(lo * hi)  # geometric: delta spans decades
                ph, c = probe(mid)
                if c < 0:  # deadline: keep the last accepted hi bracket
                    stopped = True
                    break
                if c >= self.k:
                    hi, ph_hi, c_hi = mid, ph, c
                else:
                    lo = mid

        if ph_hi is None:
            raise RuntimeError(
                "TopKSignificantQuery: no pattern can attain P <= 0.5 on "
                "this dataset (Tarone bound excludes every support)"
            )
        if ph_hi.output.emit_dropped:
            # massive P-value ties can pin the bracket above out_cap: the
            # emitted record set is then an arbitrary subset, so the k kept
            # below may not be the true best-k.  The ResultSet's complete
            # flag carries the same signal (n_dropped > 0); never silent.
            warnings.warn(
                f"top-k emission overflow: the accepted probe (delta={hi:.3e}, "
                f"{c_hi} significant) dropped {ph_hi.output.emit_dropped} "
                "records to out_cap saturation, so the returned top-k may be "
                "incomplete — raise RuntimeConfig.out_cap or lower k",
                RuntimeWarning,
                stacklevel=2,
            )
        results = session._build_results(
            dataset, ph_hi.output, alpha=float("nan"), min_sup=1,
            k=1, delta=hi, filter_host=False, statistic=self.statistic,
        )
        results.patterns = results.patterns[: self.k]
        if stopped:
            # the accepted bracket's patterns are valid, but the bisection
            # never refined delta to the exact k-th level — flag the answer
            results.truncated = True
        # all probes are reported, with the ACCEPTED one last — phases[-1]
        # is the traversal that produced the returned patterns (rejected
        # lo-side probes are near-empty runs; telemetry readers key on -1)
        phases = [p for p in phases if p is not ph_hi] + [ph_hi]
        return MineReport(
            dataset=dataset.name,
            pipeline="topk",
            alpha=float("nan"),
            lambda_final=0,
            min_sup=1,
            correction_factor=1,
            delta=hi,
            n_significant=len(results.patterns),
            results=results,
            phases=tuple(phases),
            wall_s=time.perf_counter() - t0,
            statistic=self.statistic,
            query="topk",
            partial=stopped,
            ckpt_path=phases[-1].ckpt_path,
        )


#: objective registry for launchers/config surfaces (name -> Query class)
QUERIES: dict[str, type[Query]] = {
    "significant": SignificantPatternQuery,
    "closed-frequent": ClosedFrequentQuery,
    "topk": TopKSignificantQuery,
}
