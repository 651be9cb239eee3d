"""Whether the timed path's answers are right: each against the reference.

Numbers compared, each beside its limit from the configuration's `checks`:

- `wrong_answers`: answers whose exact part differs from the reference's:
  lambda, min_sup, the correction factor, the count of significant (or
  closed) sets, and the set of patterns with their supports and positive
  supports; an incomplete result (records dropped) is wrong too;
- `unanswered`: requests that failed, timed out or came back partial;
- `pvalue_rel_gap` (LAMP queries): the largest relative gap of a pattern's
  P- or q-value from the reference's, over every pattern of every answer
  whose exact part agrees.
"""

from __future__ import annotations

import math

__all__ = ["compare", "judge", "passed"]


def rel_gap(a: float, b: float) -> float:
    if math.isnan(a) and math.isnan(b):
        return 0.0
    if math.isnan(a) or math.isnan(b):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-300)


def compare(got: dict, want: dict) -> tuple[bool, float]:
    """(exact part equal, largest P/q relative gap) of one answer."""
    same = (got.get("complete", True)
            and all(got[k] == want[k] for k in
                    ("lambda_final", "min_sup", "correction_factor", "n_significant")))
    g = {p[0]: p for p in got["patterns"]}
    w = {p[0]: p for p in want["patterns"]}
    same = same and len(g) == len(got["patterns"]) and g.keys() == w.keys() and all(
        g[k][1:3] == w[k][1:3] for k in w)
    gap = 0.0
    if same:
        for k in w:
            gap = max(gap, rel_gap(g[k][3], w[k][3]), rel_gap(g[k][4], w[k][4]))
    return bool(same), gap


def judge(answers, reference: dict, n_unanswered: int, checks: dict) -> dict:
    """{number: {"value", "limit"}} over `answers`, a list of (key, answer)
    with `reference[key]` the reference's answer to the same input."""
    wrong, gap = 0, 0.0
    for key, got in answers:
        same, g = compare(got, reference[key])
        wrong += 0 if same else 1
        gap = max(gap, g)
    out = {"wrong_answers": {"value": wrong, "limit": checks["wrong_answers"]},
           "unanswered": {"value": n_unanswered, "limit": checks["unanswered"]}}
    if "pvalue_rel_gap" in checks:
        out["pvalue_rel_gap"] = {"value": gap, "limit": checks["pvalue_rel_gap"]}
    return out


def passed(numbers: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in numbers.values())
