"""Two-level lifeline schedule: intra-host rounds + aligned cross-host rounds
(a copy of `repro.topo.hierarchy`: the same seed draws the same rounds,
names, tiers and axis rounds in both packages).

The flat schedule (core/lifeline.build_schedule) treats all P miners as
equidistant; on a multi-host mesh that makes most steal rounds pay
cross-host latency.  The survey literature's fix — and the natural reading
of the paper's §4.2 lifeline graph at scale — is locality: steal often from
host-mates (cheap), rarely across hosts (the random lifeline edges become
the *global* tier that keeps the whole machine connected).

This builder emits the exact same cyclic `(request_pairs, reply_pairs)`
round format `core/steal.py` consumes, in global miner-rank coordinates —
so a hierarchical schedule runs unchanged on a 1-D mesh (useful for
single-process oracles).  It *additionally* factorizes every round onto
exactly one axis of the 2-D topo mesh:

  * a **local** round applies the same intra-host pairing on every host —
    one `ppermute` over the "local" axis;
  * a **cross** round pairs host h with host h' at equal local rank — one
    `ppermute` over the "hosts" axis.

Each tier is itself the paper's hypercube-with-holes + frozen random
derangements, built at its own size (devices_per_host resp. n_hosts).  The
cycle inserts one cross round after every `cross_every` local rounds
(cycling the local list as needed — a cyclic schedule may repeat a round
within one grand cycle), so the cross-traffic fraction is pinned at
1 / (cross_every + 1) *regardless of H*: fatter machines don't drift
toward cross-dominated cycles just because log2(H) outgrows log2(D).

Round naming (`loc_*` / `x_*`) is load-bearing: obs/trace groups steal
telemetry by round name and splits Jain's fairness by the schedule's
`tiers` tuple, so intra- vs cross-host steal volume is observable.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.collectives import HOSTS_AXIS, LOCAL_AXIS
from repro_torch.core.lifeline import (
    LifelineSchedule,
    _hypercube_pairs,
    _random_perm_pairs,
)

from .topology import Topology

__all__ = ["build_hierarchical_schedule"]


def _expand_local(pairs, topology: Topology):
    """Intra-host (a, b) pairs -> global pairs, replicated on every host."""
    d = topology.devices_per_host
    return tuple(
        (h * d + a, h * d + b)
        for h in range(topology.n_hosts)
        for (a, b) in pairs
    )


def _expand_cross(host_pairs, topology: Topology):
    """Host-level (g, j) pairs -> global pairs at every equal local rank."""
    d = topology.devices_per_host
    return tuple(
        (g * d + local, j * d + local)
        for (g, j) in host_pairs
        for local in range(d)
    )


def _tier_rounds(p: int, n_random: int, rng) -> tuple[list, list, int]:
    """One tier's flat-style cycle at size `p`: (rounds, labels, z).

    Mirrors core/lifeline.build_schedule: rand/hc interleaved per hypercube
    dim, then extra random derangements up to `n_random`.  Rounds are in
    tier-local coordinates ([0, p) ranks).
    """
    z = max(1, int(np.ceil(np.log2(max(p, 2)))))
    rounds, labels = [], []
    ri = 0
    for d in range(z):
        rounds.append(_random_perm_pairs(p, rng))
        labels.append(f"rand{ri}")
        ri += 1
        hc = _hypercube_pairs(p, d)
        rounds.append((hc, hc))
        labels.append(f"hc{d}")
    for _ in range(max(0, n_random - z)):
        rounds.append(_random_perm_pairs(p, rng))
        labels.append(f"rand{ri}")
        ri += 1
    return rounds, labels, z


def build_hierarchical_schedule(
    topology: Topology, n_random: int = 4, seed: int = 0,
    cross_every: int = 1,
) -> LifelineSchedule:
    """Cyclic two-level steal schedule for an H x D topology.

    `cross_every` local rounds separate consecutive cross rounds — the
    knob trading global spread speed (small values) against cross-host
    latency share (large values).  The default of 1 is what the scaling
    model (topo/simulate.py) favors under a 10x cross/local latency
    ratio: a cross round's real saving over a flat round is *alignment*
    (whole-host pairings, fan-out 1 over the interconnect), so starving
    the global tier costs more supersteps than it saves in latency.

    Degenerate shapes stay sensible: H == 1 emits the local tier only
    (equivalent to a flat schedule over one host's devices), D == 1 emits
    the cross tier only (a flat schedule over hosts).  P == 1 yields one
    no-op round so the engine's round indexing stays well-defined.
    """
    H, D = topology.n_hosts, topology.devices_per_host
    rng = np.random.default_rng(seed)
    n_random = max(1, n_random)

    local, cross = [], []  # [(name, axis_pairs, global_pairs_pair)]
    z_loc = z_host = 0
    if D > 1:
        rounds, labels, z_loc = _tier_rounds(D, n_random, rng)
        for (req, rep), label in zip(rounds, labels):
            local.append((
                f"loc_{label}", (req, rep),
                (_expand_local(req, topology), _expand_local(rep, topology)),
            ))
    if H > 1:
        # the global tier cycles every dim but skips the extra decorrelation
        # randoms — the cycle length (and so the cross fraction) stays
        # governed by cross_every alone
        rounds, labels, z_host = _tier_rounds(H, 1, rng)
        for (req, rep), label in zip(rounds, labels):
            cross.append((
                f"x_{label}", (req, rep),
                (_expand_cross(req, topology), _expand_cross(rep, topology)),
            ))
    if not local and not cross:  # P == 1: one empty round, nothing to steal
        return LifelineSchedule(
            n_proc=1, dim=1, rounds=(((), ()),), names=("loc_noop",),
            round_axes=(LOCAL_AXIS,), axis_rounds=(((), ()),),
            tiers=("local",),
        )

    # pin the cross fraction: `cross_every` local rounds (cycling the local
    # list) before each cross round.  One grand cycle visits every cross
    # round once and every local round at least once.
    entries = []
    if not cross:
        entries = [("local", e) for e in local]
    elif not local:
        entries = [("cross", e) for e in cross]
    else:
        cross_every = max(1, cross_every)
        li = 0
        for xe in cross:
            for _ in range(cross_every):
                entries.append(("local", local[li % len(local)]))
                li += 1
            entries.append(("cross", xe))
        while li < len(local):  # short cross tier: finish the local cycle
            entries.append(("local", local[li]))
            li += 1

    names, axis_rounds, global_rounds, round_axes, tiers = [], [], [], [], []
    for tier, (name, axis_pair, global_pair) in entries:
        names.append(name)
        axis_rounds.append(axis_pair)
        global_rounds.append(global_pair)
        round_axes.append(LOCAL_AXIS if tier == "local" else HOSTS_AXIS)
        tiers.append(tier)
    return LifelineSchedule(
        n_proc=topology.n_proc,
        dim=z_loc + z_host,
        rounds=tuple(global_rounds),
        names=tuple(names),
        round_axes=tuple(round_axes),
        axis_rounds=tuple(axis_rounds),
        tiers=tuple(tiers),
    )
