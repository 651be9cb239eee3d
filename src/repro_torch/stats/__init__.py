"""repro_torch.stats — pluggable test statistics (counterpart of `repro.stats`).

Registered statistics: "fisher" (exact hypergeometric tail, the default).
The JAX package's "chi2" is not ported yet (ROADMAP.md, queue 1).
"""

from .base import (
    STATISTICS,
    TestStatistic,
    get_statistic,
    register_statistic,
    thresholds_from_bound,
)
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
    "FisherExact",
    "fisher_pvalue",
    "fisher_pvalue_torch",
    "lamp_count_thresholds",
    "log_comb",
    "min_attainable_pvalue",
]
