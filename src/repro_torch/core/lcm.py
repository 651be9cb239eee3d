"""Sequential closed-itemset mining (LCM, paper §2.1) — host reference path
(a copy of `repro.core.lcm`, numpy only).

Two implementations:

  * `brute_force_closed`: exponential oracle (closure of every item subset),
    used only by tests on tiny databases.

  * `lcm_closed`: stack-based LCM with *deferred PPC validation* — the exact
    algorithm the distributed engine runs, in plain numpy.  See the note below.

Deferred-PPC design (the batched adaptation of LCM's prefix-preserving-closure
extension, documented in DESIGN.md §2):

Classic LCM, at a closed set P with core item e0, extends with every item
e > e0, e not in P, and immediately checks the PPC condition
clo(P + e) ∩ [0, e) == P ∩ [0, e), which requires a per-child closure scan.
We defer that check to the child's own expansion: a node carries

    occ           occurrence bitmap of P + e  (fixed W words)
    core          the extension item e
    prefix_count  |P ∩ [0, e)|   (P = parent's closed set)

When the node is popped we compute the support vector s[j] = |occ ∩ col_j| for
ALL items in one popcount-GEMM.  Then

    clo(P + e)            = { j : s[j] == |occ| }
    |clo(P + e) ∩ [0,e)|  = #{ j < e : s[j] == |occ| }

and since P ∩ [0,e) ⊆ clo(P+e) ∩ [0,e) always holds, the PPC *set* equality is
equivalent to the *count* equality  #{j<e: s[j]==sup} == prefix_count.  A node
failing the check is a duplicate (generated by a non-canonical parent) and is
dropped.  This turns LCM's irregular per-child prefix scans into one dense
batched contraction per node — the shape tensor hardware wants — at the cost of expanding
duplicate candidates one level before rejecting them.  Every *accepted* node
is a distinct closed itemset, exactly once (PPC extensions form a spanning
tree of the closed-set lattice).

Supports counting is the popcount-GEMM of bitmap.py (paper §4.6 keeps dense
bitmaps + POPCNT; no database reduction).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from .bitmap import full_occ, pack_db, support_np, supports_np

__all__ = ["MiningStats", "brute_force_closed", "lcm_closed", "closure_np"]


@dataclass
class MiningStats:
    nodes_popped: int = 0
    nodes_rejected: int = 0  # failed deferred-PPC check (duplicates)
    closed_found: int = 0
    max_stack: int = 0
    supports_gemv: int = 0  # number of [M,W] popcount-GEMV rows computed


def closure_np(occ: np.ndarray, db_bits: np.ndarray) -> np.ndarray:
    """Item indices of clo(occ) = {j : col_j ⊇ occ}."""
    sup = support_np(occ)
    s = supports_np(occ, db_bits)
    return np.flatnonzero(s == sup)


def brute_force_closed(db_bool: np.ndarray, min_sup: int = 1):
    """Oracle: all closed itemsets with support >= min_sup, via subset enumeration.

    Returns dict {frozenset(items): support}. Exponential in item count.
    """
    db_bool = np.asarray(db_bool, dtype=bool)
    n, m = db_bool.shape
    assert m <= 20, "oracle is exponential; use tiny databases"
    db_bits = pack_db(db_bool)
    out: dict[frozenset, int] = {}
    for mask in range(1 << m):
        items = [j for j in range(m) if (mask >> j) & 1]
        occ = full_occ(n)
        for j in items:
            occ = occ & db_bits[j]
        sup = int(support_np(occ))
        if sup < min_sup:
            continue
        clo = frozenset(closure_np(occ, db_bits).tolist())
        out[clo] = sup
    return out


def lcm_closed(
    db_bool: np.ndarray,
    min_sup: int = 1,
    on_closed: Callable[[np.ndarray, int, np.ndarray], None] | None = None,
    dynamic_min_sup: Callable[[int], int] | None = None,
):
    """Stack-based LCM with deferred PPC validation (host reference).

    on_closed(occ, support, closure_items): callback per closed itemset.
    dynamic_min_sup(support): called after each counted closed set; returns the
        (possibly increased) support threshold — this is the LAMP
        support-increase hook (paper §3.3). With None, min_sup is static.

    Returns (closed_list, stats) where closed_list = [(frozenset, support)].
    """
    db_bool = np.asarray(db_bool, dtype=bool)
    n, m = db_bool.shape
    db_bits = pack_db(db_bool)
    lam = min_sup
    stats = MiningStats()
    closed: list[tuple[frozenset, int]] = []

    # root: clo(empty set).  Support = N; counted iff N >= lam.
    root_occ = full_occ(n)
    # stack entries: (occ, core_item, prefix_count). Root uses core=-1, pc=0.
    stack: list[tuple[np.ndarray, int, int]] = [(root_occ, -1, 0)]

    while stack:
        stats.max_stack = max(stats.max_stack, len(stack))
        occ, core, pc = stack.pop()
        sup = int(support_np(occ))
        if sup < lam:
            continue  # paper Fig.2: subtree untestable under current lambda
        stats.nodes_popped += 1
        s = supports_np(occ, db_bits)  # [M] popcount-GEMV
        stats.supports_gemv += 1
        in_closure = s == sup
        if core >= 0:
            q_prefix = int(np.count_nonzero(in_closure[:core]))
            if q_prefix != pc:
                stats.nodes_rejected += 1
                continue  # deferred-PPC reject: non-canonical duplicate
        clo_items = np.flatnonzero(in_closure)
        stats.closed_found += 1
        closed.append((frozenset(clo_items.tolist()), sup))
        if on_closed is not None:
            on_closed(occ, sup, clo_items)
        if dynamic_min_sup is not None:
            lam = max(lam, int(dynamic_min_sup(sup)))

        # children: items e > core, e not in closure, support >= lam.
        cand = np.flatnonzero((~in_closure) & (s >= lam) & (np.arange(m) > core))
        if cand.size == 0:
            continue
        # prefix counts for children come from THIS node's closure vector.
        clo_cum = np.cumsum(in_closure)  # clo_cum[e-1] = |clo ∩ [0, e)| for e>=1
        # push in reverse so the smallest extension item is explored first
        for e in cand[::-1]:
            child_occ = occ & db_bits[e]
            child_pc = int(clo_cum[e - 1]) if e > 0 else 0
            stack.append((child_occ, int(e), child_pc))

    return closed, stats
