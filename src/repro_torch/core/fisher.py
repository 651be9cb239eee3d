"""Back-compat shim — Fisher's exact test lives in `repro_torch.stats.fisher`
(counterpart of `repro.core.fisher`).

This module keeps the JAX package's historical import path; new code
should import from `repro_torch.stats` (functions) or use
`repro_torch.stats.get_statistic("fisher")`.
"""

from __future__ import annotations

from repro_torch.stats.fisher import (  # noqa: F401
    FisherExact,
    fisher_pvalue,
    fisher_pvalue_torch,
    lamp_count_thresholds,
    log_comb,
    min_attainable_pvalue,
)

__all__ = [
    "log_comb",
    "fisher_pvalue",
    "min_attainable_pvalue",
    "lamp_count_thresholds",
    "fisher_pvalue_torch",
]
