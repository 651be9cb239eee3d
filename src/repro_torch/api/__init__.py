"""repro_torch.api — the public mining surface (counterpart of `repro.api`).

    from repro_torch.api import Dataset, MinerSession, SignificantPatternQuery

    ds = Dataset.from_packed_words(bits, labels, n_transactions=n)  # on the card
    session = MinerSession(n_miners=8)             # P miners, program cache
    report = session.run(ds, SignificantPatternQuery(alpha=0.05))
    report = session.run(ds, SignificantPatternQuery(statistic="chi2"))
    report = session.run(ds, ClosedFrequentQuery(min_sup=50, top_k=10))
    report = session.run(ds, TopKSignificantQuery(k=10))
    print(report.summary())
    print(report.results.describe(10))
    print(session.cache_info())

`Dataset` packs the occurrence bitmap once onto its device and pads to a
shape bucket; `Query` objects (query.py) are the mining objectives, all
executed by one engine; `MinerSession` caches BSP programs by (mode,
bucket, runtime config, statistic) with LRU bounding so phases, repeat
queries and same-bucket datasets share them; `MineReport`/`PhaseReport`
are the typed answers.  Everything runs on the card unless the Dataset and
the session are given device="cpu".
"""

from .config import AlgorithmConfig, RuntimeConfig
from .dataset import (
    DEFAULT_BUCKETS,
    EXACT_BUCKETS,
    BucketPolicy,
    Dataset,
    ShapeBucket,
)
from .query import (
    QUERIES,
    ClosedFrequentQuery,
    Query,
    SignificantPatternQuery,
    TopKSignificantQuery,
)
from .report import MineReport, PhaseReport
from .session import PIPELINES, CacheInfo, MinerSession, ProgramInfo

__all__ = [
    "AlgorithmConfig",
    "BucketPolicy",
    "CacheInfo",
    "ClosedFrequentQuery",
    "Dataset",
    "DEFAULT_BUCKETS",
    "EXACT_BUCKETS",
    "MineReport",
    "MinerSession",
    "PhaseReport",
    "PIPELINES",
    "ProgramInfo",
    "QUERIES",
    "Query",
    "RuntimeConfig",
    "ShapeBucket",
    "SignificantPatternQuery",
    "TopKSignificantQuery",
]
