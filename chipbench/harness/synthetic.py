"""The seeded generator of the paper's Table 1 databases, straight into words.

A copy of `repro_torch.data.synthetic.generate_packed` (with `pack_db` and
`num_words` from `repro_torch.core.bitmap`), kept here so that a change to
the program cannot move the benchmark's inputs: the same spec gives the
same arrays as the original (`tests/test_chipbench_harness.py` holds the
two together).  Bit t of word w is transaction 32 w + t.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

WORD_BITS = 32


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


def num_words(n_transactions: int) -> int:
    return (n_transactions + WORD_BITS - 1) // WORD_BITS


def pack_db(db_bool: np.ndarray) -> np.ndarray:
    """[N_transactions, M_items] bool -> [M, W] uint32 (bit t of word w = transaction 32w+t)."""
    db_bool = np.asarray(db_bool, dtype=bool)
    n, m = db_bool.shape
    w = num_words(n)
    padded = np.zeros((w * WORD_BITS, m), dtype=bool)
    padded[:n] = db_bool
    bytes_ = np.packbits(padded, axis=0, bitorder="little")  # [W*4, M]
    words = bytes_.reshape(w, 4, m).astype(np.uint32)
    out = words[:, 0] | (words[:, 1] << 8) | (words[:, 2] << 16) | (words[:, 3] << 24)
    return np.ascontiguousarray(out.T)  # [M, W]


def generate_packed(
    spec: SyntheticSpec, item_chunk: int = 8192,
) -> tuple[np.ndarray, np.ndarray, list[list[int]]]:
    """(db_bits [M, W] u32, labels [N] bool, planted itemsets) for `spec`.

    Skewed per-item marginals with mean `density`, and `n_planted`
    positive-enriched itemsets; item columns are drawn `item_chunk` at a
    time and packed at once, so no dense [N, M] matrix is held.
    """
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


def unpack_words(db_bits: np.ndarray, n: int) -> np.ndarray:
    """[M, W] uint32 words -> [M, n] bool (item-major)."""
    words = np.ascontiguousarray(db_bits, dtype=np.uint32)
    bits = np.unpackbits(words.view(np.uint8), axis=1, bitorder="little")
    return bits[:, :n].astype(bool)


def permute_transactions(db_bits: np.ndarray, labels: np.ndarray, perm: np.ndarray,
                         item_chunk: int = 16384) -> tuple[np.ndarray, np.ndarray]:
    """The same database with its transactions (bits and labels) reordered:
    transaction t of the result is transaction perm[t] of the input.  Every
    itemset keeps its support and positive support, so the closed sets, and
    with them the mining work, do not change."""
    m, nw = db_bits.shape
    n = len(labels)
    out = np.empty((m, nw), dtype=np.uint32)
    for lo in range(0, m, item_chunk):
        cols = unpack_words(db_bits[lo:lo + item_chunk], n)[:, perm]  # [chunk, n]
        out[lo:lo + item_chunk] = pack_db(cols.T)
    out.flags.writeable = False
    new_labels = np.asarray(labels, dtype=bool)[perm].copy()
    new_labels.flags.writeable = False
    return out, new_labels
