"""repro_torch.stats — pluggable test statistics (counterpart of `repro.stats`).

Registered statistics: "fisher" (exact hypergeometric tail, the default)
and "chi2" (continuity-corrected one-sided chi-square upper bound).
"""

from .base import (
    STATISTICS,
    TestStatistic,
    get_statistic,
    register_statistic,
    thresholds_from_bound,
)
from .chi2 import ChiSquared, chi2_pvalue, chi2_pvalue_torch
from .fisher import (
    FisherExact,
    fisher_pvalue,
    fisher_pvalue_torch,
    lamp_count_thresholds,
    log_comb,
    min_attainable_pvalue,
)

__all__ = [
    "STATISTICS",
    "TestStatistic",
    "get_statistic",
    "register_statistic",
    "thresholds_from_bound",
    "ChiSquared",
    "chi2_pvalue",
    "chi2_pvalue_torch",
    "FisherExact",
    "fisher_pvalue",
    "fisher_pvalue_torch",
    "lamp_count_thresholds",
    "log_comb",
    "min_attainable_pvalue",
]
