"""Lifeline graph: hypercube with random edges (paper §4.2, Saraswat GLB).

A copy of `repro.core.lifeline` (numpy only): the same seed draws the same
rounds in both packages.

The paper sets l=2 (binary hypercube of smallest dimension z with P <= 2^z)
and w=1 random steal attempts.  The BSP adaptation needs *permutations* for
`lax.ppermute`, which are static per call site:

  * hypercube dim d  ->  the involution  i <-> i XOR 2^d  (pairs where both
    endpoints exist; GLB's "hypercube with holes" for non-power-of-two P)
  * random edges     ->  a fixed pool of R random permutations drawn at launch
    (the paper's random victim choice, frozen into the round schedule; the
    lifeline graph itself is likewise fixed per run)

The steal schedule cycles:  random, hc_0, random, hc_1, ..., random, hc_{z-1},
so every (z+... ) window contains w=1 random attempt per lifeline attempt,
mirroring the paper's Steal() loop (1 random try then the z lifeline tries).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["LifelineSchedule", "build_schedule"]


@dataclass(frozen=True)
class LifelineSchedule:
    n_proc: int
    dim: int  # z
    # each entry: (request_pairs, reply_pairs) as tuples of (src, dst) in
    # *global* miner-rank coordinates — what the census-indexed REQUEST
    # table and any single-axis mesh consume
    rounds: tuple
    names: tuple  # debug labels, e.g. ("rand0", "hc0", "rand1", "hc1", ...)
    # -------- two-level (topology-factorized) extension (not ported yet) --
    # A hierarchical schedule additionally factorizes every round onto ONE
    # mesh axis of the [hosts, local] topo mesh: `round_axes[r]` names that
    # axis and `axis_rounds[r]` holds the same (request, reply) pairs in
    # that axis's own coordinates (identical pairing replicated along the
    # other axis).  None (the flat default) means the schedule can only run
    # on a 1-D mesh via its global `rounds`.
    round_axes: tuple | None = None
    axis_rounds: tuple | None = None
    # per-round steal tier for telemetry: "local" (intra-host) | "cross"
    # (host-crossing) | "flat" (one-level schedule — no tier structure)
    tiers: tuple | None = None

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)

    @property
    def factorized(self) -> bool:
        """True when every round maps onto a single topo-mesh axis."""
        return self.round_axes is not None

    def round_tier(self, r: int) -> str:
        return "flat" if self.tiers is None else self.tiers[r]


def _hypercube_pairs(p: int, d: int):
    pairs = []
    for i in range(p):
        j = i ^ (1 << d)
        if j < p:
            pairs.append((i, j))
    return tuple(pairs)  # involution: request and reply use the same pairs


def _random_perm_pairs(p: int, rng: np.random.Generator):
    # derangement-ish: resample until no fixed points (self-steals are wasted)
    while True:
        perm = rng.permutation(p)
        if p == 1 or not np.any(perm == np.arange(p)):
            break
    req = tuple((i, int(perm[i])) for i in range(p))
    inv = np.empty(p, dtype=np.int64)
    inv[perm] = np.arange(p)
    rep = tuple((i, int(inv[i])) for i in range(p))
    return req, rep


def build_schedule(n_proc: int, n_random: int = 4, seed: int = 0) -> LifelineSchedule:
    """Cyclic steal-round schedule for P processes (paper: l=2, w=1)."""
    assert n_proc >= 1
    z = max(1, int(np.ceil(np.log2(max(n_proc, 2)))))
    rng = np.random.default_rng(seed)
    rounds = []
    names = []
    n_random = max(1, n_random)
    ri = 0
    for d in range(z):
        req, rep = _random_perm_pairs(n_proc, rng)
        rounds.append((req, rep))
        names.append(f"rand{ri}")
        ri += 1
        hc = _hypercube_pairs(n_proc, d)
        rounds.append((hc, hc))
        names.append(f"hc{d}")
    # extra random permutations to decorrelate long runs
    for _ in range(max(0, n_random - z)):
        req, rep = _random_perm_pairs(n_proc, rng)
        rounds.append((req, rep))
        names.append(f"rand{ri}")
        ri += 1
    return LifelineSchedule(n_proc=n_proc, dim=z, rounds=tuple(rounds), names=tuple(names))
