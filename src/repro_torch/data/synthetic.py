"""Synthetic transaction databases matched to the paper's Table 1 statistics.

A copy of `repro.data.synthetic` (numpy only): the same seeds give
identical arrays in both packages.

HapMap / Alzheimer GWAS matrices are access-controlled, so benchmarks run on
synthetic datasets that match the published (items, transactions, density,
N_pos) and contain *planted* significant itemsets so phase 3 has real signal.

The planting scheme: pick `n_planted` itemsets of size 2-4; choose a positive-
enriched occurrence pattern for each (present in a fraction of positives and a
much smaller fraction of negatives); the remaining cells are iid Bernoulli at
the target density.  Items are mildly power-law weighted so the LCM tree is
*unbalanced* — the property that breaks the naive search-space split (paper
§5.4) and motivates work stealing.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "SyntheticSpec",
    "PAPER_PROBLEMS",
    "generate",
    "generate_packed",
    "paper_problem",
    "paper_problem_packed",
]


@dataclass(frozen=True)
class SyntheticSpec:
    name: str
    n_items: int
    n_transactions: int
    density: float
    n_pos: int
    n_planted: int = 3
    planted_pos_rate: float = 0.6
    planted_neg_rate: float = 0.05
    skew: float = 1.2  # power-law exponent for per-item frequency skew
    seed: int = 0


# Table 1 of the paper, scaled where noted by benchmarks (full sizes kept here).
PAPER_PROBLEMS = {
    "hapmap_dom_10": SyntheticSpec("hapmap_dom_10", 11_253, 697, 0.0102, 105),
    "hapmap_dom_20": SyntheticSpec("hapmap_dom_20", 11_914, 697, 0.0191, 105),
    "alz_dom_5": SyntheticSpec("alz_dom_5", 44_052, 364, 0.0540, 176),
    "alz_dom_10": SyntheticSpec("alz_dom_10", 91_126, 364, 0.0978, 176),
    "alz_rec_30": SyntheticSpec("alz_rec_30", 250_120, 364, 0.0290, 176),
    "mcf7": SyntheticSpec("mcf7", 397, 12_773, 0.0294, 1_129),
}


def generate(spec: SyntheticSpec) -> tuple[np.ndarray, np.ndarray, list[list[int]]]:
    """Returns (db_bool [N, M], labels [N] bool, planted itemsets)."""
    rng = np.random.default_rng(spec.seed)
    n, m = spec.n_transactions, spec.n_items
    labels = np.zeros(n, dtype=bool)
    labels[rng.choice(n, size=spec.n_pos, replace=False)] = True

    # skewed per-item marginal frequencies with mean = density
    w = rng.pareto(spec.skew, size=m) + 1.0
    p_item = w / w.mean() * spec.density
    p_item = np.clip(p_item, 0.0, 0.95)
    db = rng.random((n, m)) < p_item[None, :]

    planted: list[list[int]] = []
    for _ in range(spec.n_planted):
        size = int(rng.integers(2, 5))
        items = rng.choice(m, size=size, replace=False).tolist()
        carrier = np.where(
            labels, rng.random(n) < spec.planted_pos_rate, rng.random(n) < spec.planted_neg_rate
        )
        for j in items:
            db[carrier, j] = True
        planted.append(sorted(items))
    return db, labels, planted


def generate_packed(
    spec: SyntheticSpec, item_chunk: int = 8192,
) -> tuple[np.ndarray, np.ndarray, list[list[int]]]:
    """`generate` straight into packed words: (db_bits [M, W] u32, labels, planted).

    The paper-scale generator (alz_rec_30: 250,120 items x 364 transactions).
    `generate` draws a dense [n, m] float64 matrix — ~728 MB for alz_rec_30 —
    before a single superstep runs; here item columns are drawn `item_chunk`
    at a time and packed immediately, so peak memory is the packed output
    (M * W * 4 bytes, ~12 MB at alz_rec_30) plus one chunk.

    Same model as `generate` (skewed marginals, planted positive-enriched
    itemsets) but a *different* random stream — the chunked draw order
    differs — so packed and dense problems of one spec are statistically
    matched, not bit-equal.  Planting ORs the carrier's packed words into
    the chosen item columns, exactly mirroring `db[carrier, j] = True`.
    """
    from repro_torch.core.bitmap import num_words, pack_db

    rng = np.random.default_rng(spec.seed)
    n, m = spec.n_transactions, spec.n_items
    labels = np.zeros(n, dtype=bool)
    labels[rng.choice(n, size=spec.n_pos, replace=False)] = True

    w = rng.pareto(spec.skew, size=m) + 1.0
    p_item = w / w.mean() * spec.density
    p_item = np.clip(p_item, 0.0, 0.95)

    nw = num_words(n)
    db_bits = np.empty((m, nw), dtype=np.uint32)
    for lo in range(0, m, item_chunk):
        hi = min(lo + item_chunk, m)
        cols = rng.random((n, hi - lo)) < p_item[None, lo:hi]
        db_bits[lo:hi] = pack_db(cols)

    planted: list[list[int]] = []
    for _ in range(spec.n_planted):
        size = int(rng.integers(2, 5))
        items = rng.choice(m, size=size, replace=False).tolist()
        carrier = np.where(
            labels,
            rng.random(n) < spec.planted_pos_rate,
            rng.random(n) < spec.planted_neg_rate,
        )
        carrier_bits = pack_db(carrier[:, None])[0]  # [W] u32
        for j in items:
            db_bits[j] |= carrier_bits
        planted.append(sorted(items))
    db_bits.flags.writeable = False
    return db_bits, labels, planted


def paper_problem(name: str, scale_items: float = 1.0, scale_trans: float = 1.0,
                  seed: int | None = None) -> tuple[np.ndarray, np.ndarray, list[list[int]], SyntheticSpec]:
    """A (possibly scaled-down) instance of one of the paper's Table-1 problems."""
    base = PAPER_PROBLEMS[name]
    spec = SyntheticSpec(
        name=base.name,
        n_items=max(8, int(base.n_items * scale_items)),
        n_transactions=max(16, int(base.n_transactions * scale_trans)),
        density=base.density,
        n_pos=max(4, int(base.n_pos * scale_trans)),
        n_planted=base.n_planted,
        seed=base.seed if seed is None else seed,
    )
    db, labels, planted = generate(spec)
    return db, labels, planted, spec


def paper_problem_packed(
    name: str, scale_items: float = 1.0, scale_trans: float = 1.0,
    seed: int | None = None,
) -> tuple[np.ndarray, np.ndarray, list[list[int]], SyntheticSpec]:
    """`paper_problem` via the packed generator: (db_bits [M, W], labels,
    planted, spec) with no dense [n, m] intermediate — the entry for
    full-size Table-1 problems (alz_rec_30 at 250k items)."""
    base = PAPER_PROBLEMS[name]
    spec = SyntheticSpec(
        name=base.name,
        n_items=max(8, int(base.n_items * scale_items)),
        n_transactions=max(16, int(base.n_transactions * scale_trans)),
        density=base.density,
        n_pos=max(4, int(base.n_pos * scale_trans)),
        n_planted=base.n_planted,
        seed=base.seed if seed is None else seed,
    )
    db_bits, labels, planted = generate_packed(spec)
    return db_bits, labels, planted, spec
