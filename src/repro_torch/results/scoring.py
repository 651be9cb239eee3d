"""Planted-pattern recovery scoring (the §5.6 sanity check, automated).

A copy of `repro.results.scoring`.

`data/synthetic.py` plants positive-enriched itemsets into its case-control
matrices; a correct end-to-end run must rediscover them.  A planted itemset
counts as *recovered* when some mined pattern's closure contains it — the
closure of a planted set usually picks up the planted items plus any items
that co-occur by construction, so subset containment (not equality) is the
right match criterion (benchmarks/mining_suite.py uses the same rule).
"""

from __future__ import annotations

from typing import Iterable, Sequence

__all__ = ["score_planted"]


def score_planted(patterns: Iterable, planted: Sequence[Sequence[int]]) -> dict:
    """Precision/recall of mined patterns against the planted ground truth.

    patterns: an iterable of Pattern (or anything with .items) — pass a
    ResultSet directly.  planted: list of item-id lists from generate().

    recall     = fraction of planted itemsets contained in >= 1 mined pattern
    precision  = fraction of mined patterns containing >= 1 planted itemset
                 (the rest are statistically significant background discoveries,
                 not necessarily errors — synthetic noise can be significant)
    """
    mined = [set(p.items) for p in patterns]
    planted_sets = [set(pl) for pl in planted]

    recovered = [sorted(pl) for pl in planted_sets
                 if any(pl <= s for s in mined)]
    missed = [sorted(pl) for pl in planted_sets
              if not any(pl <= s for s in mined)]
    matched = sum(1 for s in mined if any(pl <= s for pl in planted_sets))

    return {
        "n_planted": len(planted_sets),
        "n_mined": len(mined),
        "recovered": recovered,
        "missed": missed,
        "recall": len(recovered) / len(planted_sets) if planted_sets else 1.0,
        "precision": matched / len(mined) if mined else 0.0,
    }
