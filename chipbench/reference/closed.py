"""Closed itemsets of a boolean database, enumerated in plain NumPy.

An itemset is closed when no item can be added without losing a
transaction; its support is the number of transactions that hold it.  The
enumeration walks LCM's tree of prefix-preserving closure extensions
(Uno et al., 2004): a node is an occurrence set, its closure is every item
whose column covers that set, and a child extends the closure by one later
item.  A child whose closure gains an item before that extension item is
not canonical and is dropped.  Supports are counted as a float32 matrix
product of 0/1 rows (exact: every count is below 2**24), many nodes at a
time, so the reference shares no code with the program's bit counting.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["ClosedSet", "closed_itemsets", "round_bfloat16"]

#: (items as a sorted tuple of column ids, support, positive support)
ClosedSet = tuple[tuple[int, ...], int, int]


def round_bfloat16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (8 significant bits, ties to even)."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def closed_itemsets(
    db: np.ndarray,
    labels: np.ndarray,
    min_sup: int,
    *,
    raise_threshold: Callable[[np.ndarray], int] | None = None,
    counts: str = "exact",
    batch: int = 1024,
) -> list[ClosedSet]:
    """Every closed itemset of `db` ([N transactions, M items] bool) whose
    support is at least the threshold, the empty itemset's closure included.

    `raise_threshold(supports)` is called with the supports of each batch of
    new closed sets and returns the threshold from then on (LAMP's support
    increase); subtrees below the threshold are not walked.  With it the
    list holds what was found before each raise and is complete only above
    the final threshold.  `counts="bfloat16"` rounds every support to
    bfloat16 (the control of a check, never the reference itself).
    """
    db = np.asarray(db, dtype=bool)
    labels = np.asarray(labels, dtype=bool)
    n, _ = db.shape
    lam = int(min_sup)
    # an item below the threshold is in no closure above it
    items = np.flatnonzero(db.sum(axis=0) >= lam)
    cols = db[:, items]                                  # [N, Mk]
    cols_f = cols.astype(np.float32)
    rows_t = np.ascontiguousarray(cols.T)                # [Mk, N]
    pos = labels.astype(np.float32)
    mk = len(items)
    order = np.arange(mk)

    def count(x: np.ndarray) -> np.ndarray:
        x = np.rint(x).astype(np.float32)
        return round_bfloat16(x) if counts == "bfloat16" else x

    found: list[ClosedSet] = []
    # a stack of node chunks: (occurrence rows [k, N] bool, core [k], prefix count [k])
    stack = [(np.ones((1, n), dtype=bool), np.array([-1]), np.array([0]))]
    while stack:
        occ, core, pc = stack.pop()
        if len(core) > batch:
            stack.append((occ[:-batch], core[:-batch], pc[:-batch]))
            occ, core, pc = occ[-batch:], core[-batch:], pc[-batch:]
        sup = count(occ.sum(axis=1))
        live = sup >= lam
        occ, core, pc, sup = occ[live], core[live], pc[live], sup[live]
        if not len(core):
            continue
        occ_f = occ.astype(np.float32)
        s = count(occ_f @ cols_f)                        # [B, Mk]
        in_clo = s == sup[:, None]
        cum = np.cumsum(in_clo, axis=1)
        before = np.where(core > 0, cum[np.arange(len(core)), np.maximum(core - 1, 0)], 0)
        canonical = (core < 0) | (before == pc)
        occ, core, sup, s, in_clo, cum = (
            occ[canonical], core[canonical], sup[canonical], s[canonical],
            in_clo[canonical], cum[canonical])
        if not len(core):
            continue
        pos_sup = np.rint(occ.astype(np.float32) @ pos).astype(np.int64)
        for b in range(len(core)):
            found.append((tuple(int(j) for j in items[in_clo[b]]), int(sup[b]), int(pos_sup[b])))
        if raise_threshold is not None:
            lam = max(lam, int(raise_threshold(sup.astype(np.int64))))
        grow = (~in_clo) & (s >= lam) & (order[None, :] > core[:, None])
        bi, ei = np.nonzero(grow)
        if len(bi):
            child_pc = np.where(ei > 0, cum[bi, np.maximum(ei - 1, 0)], 0)
            stack.append((occ[bi] & rows_t[ei], ei, child_pc))
    return found
