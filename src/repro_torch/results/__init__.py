"""Pattern emission results subsystem (counterpart of `repro.results`).

Turns the engine's device-side pattern records (occurrence bitmap + core +
sup + pos_sup) into the run's actual deliverable: the identified significant
itemsets with exact statistics, ready for top-k selection, export, and
planted-signal scoring.
"""

from .reconstruct import dedup_by_closure, reconstruct_closures
from .resultset import Pattern, ResultSet, ResultStream, build_result_set
from .scoring import score_planted

__all__ = [
    "Pattern",
    "ResultSet",
    "ResultStream",
    "build_result_set",
    "dedup_by_closure",
    "reconstruct_closures",
    "score_planted",
]
