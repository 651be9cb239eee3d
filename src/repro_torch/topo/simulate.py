"""Host-side BSP work-stealing simulator over real enumeration trees (a copy
of `repro.topo.simulate`, numpy only).

The engine runs P virtual miners on one card, where wall-clock at P in the
hundreds says nothing about a machine of that many processors.  This
module is the paper's scaling model for that regime — P in the hundreds
to thousands (Fig. 5's 1175x point is 1216 cores): it *replays the
engine's superstep semantics in numpy* over the real deferred-PPC
enumeration tree of a dataset:

  * the tree comes from the traversal the sequential oracle
    (`repro_torch.core.lcm.lcm_closed`) runs, including the duplicate candidates
    the engine pops and rejects (they cost real pops), so node counts and
    subtree shapes are not synthetic;
  * each superstep pops <= expand_batch nodes LIFO per miner, pushes that
    node's children, takes the hunger census, and runs one steal round of
    the given lifeline schedule with the engine's exact donation rule
    (victim donates bottom floor(sp/2) capped at steal_max iff its round
    requester is hungry);
  * per-superstep cost = c_node * max_p popped[p] + census + (steal-round
    latency iff anyone is hungry — the JAX engine's `lax.cond` gate).

The round latency is what the topology changes: an intra-host hop costs
`c_local`, a cross-host hop `c_cross` (an order of magnitude more — DCN vs
ICI scale).  Hierarchical schedules pay `c_cross` only on their rare
cross rounds; a *flat* schedule's rounds are costed honestly per round
under the block rank->host mapping — hypercube dims below log2(
devices_per_host) stay intra-host, everything else (all random perms)
crosses hosts.  That bimodal steal latency is exactly the effect the
paper's hierarchical redesign (§4.2) targets.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.lifeline import LifelineSchedule

from .topology import Topology

__all__ = [
    "C_NODE_S",
    "C_LOCAL_ROUND_S",
    "C_CROSS_ROUND_S",
    "Tree",
    "extract_tree",
    "SimResult",
    "simulate_mine",
    "sync_cost",
    "round_costs",
]

C_NODE_S = 2e-6         # default per-node expand cost (calibratable)
C_LOCAL_ROUND_S = 5e-6  # intra-host collective hop (ICI/shared-memory scale)
C_CROSS_ROUND_S = 50e-6  # cross-host collective hop (DCN scale)


@dataclass(frozen=True)
class Tree:
    """A real deferred-PPC enumeration tree: `children[i]` are the node ids
    pushed when node i is popped (empty for leaves and PPC rejects)."""

    children: tuple  # tuple[tuple[int, ...], ...]

    @property
    def n_nodes(self) -> int:
        return len(self.children)

    @property
    def roots(self) -> tuple:
        """Depth-1 nodes — what the engine's host preprocessing deals."""
        return self.children[0]


def extract_tree(db_bool: np.ndarray, min_sup: int = 1,
                 max_nodes: int = 2_000_000) -> Tree:
    """The enumeration tree the sequential LCM oracle walks, as children lists.

    Mirrors the loop of `repro_torch.core.lcm.lcm_closed` (static min_sup)
    but records structure: every node the engine would *pop* gets an id —
    including deferred-PPC duplicates, which become childless nodes
    (popped, then rejected).
    """
    from repro_torch.core.bitmap import full_occ, pack_db, supports_np

    db_bool = np.asarray(db_bool, dtype=bool)
    n, m = db_bool.shape
    db_bits = pack_db(db_bool)
    children: list[list[int]] = [[]]
    # work stack: (node_id, occ, core_item, prefix_count)
    stack = [(0, full_occ(n), -1, 0)]
    while stack:
        nid, occ, core, pc = stack.pop()
        sup = int(np.bitwise_count(occ).sum())
        s = supports_np(occ, db_bits)
        in_closure = s == sup
        if core >= 0 and int(np.count_nonzero(in_closure[:core])) != pc:
            continue  # PPC reject: popped by the engine, no children
        cand = np.flatnonzero(
            (~in_closure) & (s >= min_sup) & (np.arange(m) > core)
        )
        clo_cum = np.cumsum(in_closure)
        for e in cand[::-1]:
            cid = len(children)
            if cid > max_nodes:
                raise RuntimeError(
                    f"enumeration tree exceeds {max_nodes} nodes; raise "
                    "min_sup or shrink the dataset"
                )
            children.append([])
            children[nid].append(cid)
            child_pc = int(clo_cum[e - 1]) if e > 0 else 0
            stack.append((cid, occ & db_bits[e], int(e), child_pc))
    return Tree(children=tuple(tuple(c) for c in children))


def sync_cost(topology: Topology, c_local: float = C_LOCAL_ROUND_S,
              c_cross: float = C_CROSS_ROUND_S) -> float:
    """Modeled hunger-census latency.

    Intra-host stage: a log-tree over local links.  Host stage: the census
    payload is 4 bytes per rank, so the cross-host allreduce is pure
    latency — modeled as one up-sweep plus one down-sweep over the
    interconnect (switch-assisted/in-network reduction; a software
    recursive-doubling tree would pay ceil(log2 H) hops instead, which
    penalizes *both* schedules equally — the census is global either way,
    so this cost is schedule-independent)."""
    c = 0.0
    if topology.devices_per_host > 1:
        c += c_local * math.ceil(math.log2(topology.devices_per_host))
    if topology.n_hosts > 1:
        c += 2 * c_cross
    return c


def round_costs(schedule: LifelineSchedule, topology: Topology,
                c_local: float = C_LOCAL_ROUND_S,
                c_cross: float = C_CROSS_ROUND_S) -> list:
    """Per-round steal-exchange latency from the reply pairs themselves,
    under the block rank->host mapping (flat and hierarchical rounds are
    costed by one rule — no tier is taken on faith):

      * fully intra-host permutation -> `c_local`;
      * crossing hosts -> `c_cross`, plus `c_local` per *additional
        distinct peer host* any single source host scatters to.

    The fan-out term is what separates the schedules at equal "did it
    cross" granularity: a hierarchical cross round pairs whole hosts
    (every message from host g lands on one host j — fan-out 1), while a
    flat random derangement scatters each host's D messages over up to D
    distinct peer hosts, serializing D message setups on one NIC."""
    out = []
    for req, rep in schedule.rounds:
        fan: dict = {}
        for s, d in rep:
            if s != d and not topology.same_host(s, d):
                fan.setdefault(topology.host_of(s), set()).add(
                    topology.host_of(d)
                )
        if not fan:
            out.append(c_local)
        else:
            widest = max(len(peers) for peers in fan.values())
            out.append(c_cross + (widest - 1) * c_local)
    return out


@dataclass(frozen=True)
class SimResult:
    supersteps: int
    makespan_s: float
    total_popped: int
    popped_per_miner: tuple     # lifetime pops by rank
    steals: int                 # successful receptions
    steal_rounds_fired: int     # supersteps whose exchange actually ran
    cross_round_s: float        # latency paid on cross-host steal rounds
    local_round_s: float        # latency paid on intra-host steal rounds
    sync_s: float               # latency paid on hunger censuses
    node_s: float               # critical-path expand seconds


def simulate_mine(tree: Tree, schedule: LifelineSchedule,
                  topology: Topology, *,
                  expand_batch: int = 16, steal_max: int = 256,
                  steal_enabled: bool = True,
                  c_node: float = C_NODE_S,
                  c_local: float = C_LOCAL_ROUND_S,
                  c_cross: float = C_CROSS_ROUND_S,
                  max_steps: int = 1_000_000) -> SimResult:
    """Replay one count-phase mine of `tree` on P simulated miners.

    Semantics mirror core/engine.py's superstep: EXPAND pops up to
    expand_batch LIFO and pushes children; the census counts empty stacks;
    STEAL runs round t % R — victims with a hungry round-requester donate
    the bottom half of their stack (oldest, shallowest subtrees), capped at
    steal_max; termination when every stack is empty.  Root deal is the
    engine's round-robin: depth-1 node i goes to miner i mod P.
    """
    P = topology.n_proc
    if schedule.n_proc != P:
        raise ValueError(
            f"schedule is sized for {schedule.n_proc} miners, topology has {P}"
        )
    children = tree.children
    roots = tree.roots
    stacks: list[list] = [[] for _ in range(P)]
    for i, nid in enumerate(roots):
        stacks[i % P].append(nid)
    R = schedule.n_rounds
    costs = round_costs(schedule, topology, c_local, c_cross)
    c_sync = sync_cost(topology, c_local, c_cross)
    popped_total = [0] * P
    steals = 0
    fired = 0
    node_s = sync_s = local_s = cross_s = 0.0
    t = 0
    while True:
        if t >= max_steps:
            raise RuntimeError(f"simulation exceeded {max_steps} supersteps")
        # EXPAND: batch-pop then push all children (engine order)
        step_max = 0
        for p in range(P):
            st = stacks[p]
            k = min(expand_batch, len(st))
            if k:
                popped = [st.pop() for _ in range(k)]
                for nid in popped:
                    st.extend(children[nid])
                popped_total[p] += k
                step_max = max(step_max, k)
        node_s += c_node * step_max
        sync_s += c_sync
        t += 1
        # census (exact termination, doubles as the REQUEST side)
        hungry = [not stacks[p] for p in range(P)]
        n_hungry = sum(hungry)
        if n_hungry == P:
            break
        # STEAL: one gated exchange round
        if steal_enabled and n_hungry > 0:
            r = (t - 1) % R
            fired += 1
            if costs[r] >= c_cross:
                cross_s += costs[r]
            else:
                local_s += costs[r]
            req_pairs, _rep = schedule.rounds[r]
            moves = []
            for s, d in req_pairs:
                if s == d or not hungry[s]:
                    continue
                sp = len(stacks[d])
                if sp > 1:
                    moves.append((s, d, min(sp // 2, steal_max)))
            for s, d, k in moves:  # apply simultaneously (one collective)
                stacks[s] = stacks[d][:k]   # bottom k: oldest subtrees
                stacks[d] = stacks[d][k:]
                steals += 1
    return SimResult(
        supersteps=t,
        makespan_s=node_s + sync_s + local_s + cross_s,
        total_popped=sum(popped_total),
        popped_per_miner=tuple(popped_total),
        steals=steals,
        steal_rounds_fired=fired,
        cross_round_s=cross_s,
        local_round_s=local_s,
        sync_s=sync_s,
        node_s=node_s,
    )
