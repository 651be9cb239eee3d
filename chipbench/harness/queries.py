"""The query each configuration asks, in the program and in the reference.

`config["query"]["kind"]` is "significant" (LAMP: alpha from the traffic,
the pipeline and statistic from the configuration) or "closed_frequent"
(min_sup from the traffic).  The program's side builds `repro_torch.api`
query objects; the reference's side calls `chipbench/reference/`, which
imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

from ..reference.lamp import closed_query, lamp_query

__all__ = ["answer_of", "program_query", "reference_answer", "warmup_spec"]


def program_query(config: dict, params: dict):
    from repro_torch.api import ClosedFrequentQuery, SignificantPatternQuery

    q = config["query"]
    if q["kind"] == "significant":
        return SignificantPatternQuery(alpha=float(params["alpha"]), pipeline=q["pipeline"],
                                       statistic=q["statistic"])
    if q["kind"] == "closed_frequent":
        return ClosedFrequentQuery(min_sup=int(params["min_sup"]))
    raise ValueError(f"unknown query kind {q['kind']!r}")


def warmup_spec(config: dict) -> tuple[str | None, str]:
    """(statistic, pipeline) whose programs a fleet warms for this query."""
    q = config["query"]
    if q["kind"] == "significant":
        return q["statistic"], q["pipeline"]
    return None, "three_phase"


def reference_answer(config: dict, db: np.ndarray, labels: np.ndarray, params: dict,
                     control: bool = False) -> dict:
    """The reference's answer; `control=True` computes it one precision
    below what the configuration states (float32 P-values for a LAMP
    query, bfloat16 supports for a closed-frequent one)."""
    kind = config["query"]["kind"]
    if kind == "significant":
        if config["query"]["statistic"] != "fisher":
            raise ValueError("the reference tests with Fisher's exact test only")
        return lamp_query(db, labels, float(params["alpha"]),
                          dtype=np.float32 if control else np.float64)
    if kind == "closed_frequent":
        return closed_query(db, labels, int(params["min_sup"]),
                            counts="bfloat16" if control else "exact")
    raise ValueError(f"unknown query kind {kind!r}")


def answer_of(report) -> dict:
    """A program `MineReport` in the reference's terms."""
    res = report.results
    return dict(
        lambda_final=int(report.lambda_final), min_sup=int(report.min_sup),
        correction_factor=int(report.correction_factor),
        n_significant=int(report.n_significant), complete=bool(res.complete),
        patterns=[(tuple(int(j) for j in p.items), int(p.support), int(p.pos_support),
                   float(p.pvalue), float(p.qvalue)) for p in res.patterns],
    )

