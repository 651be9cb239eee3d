"""Superstep phase 2 — STEAL: one lifeline/random work-exchange round.

Counterpart of `repro.core.steal`, over the P miners of one device.
Hungry miners (empty stack) request along the round's permutation; a
victim donates the bottom half of its stack (oldest/shallowest subtrees),
capped at `steal_max` nodes, to its requester.  The JAX version's
collectives become indexing:

* `axis_index` is `arange(P)`; the REQUEST side reads the requester's bit
  out of the hunger census through a static [R, P] requester table, as
  there;
* the GIVE/REJECT `ppermute` is a gather by a static [R, P] source table:
  miner d receives the payload of the miner that replies to it in round r,
  and a miner nobody replies to receives zeros (a zero k *is* the REJECT).

The JAX version gates the exchange on "anyone hungry"; here it runs every
superstep, since with nobody hungry every k is 0 and the payload is all
zeros, which leaves the stacks as they were.

Across processes (a `core.collectives.MinerGroup`) the round splits in
three: what this process's miners donate (local), the exchange, and what
they receive (local).  A round whose reply pairs all stay inside each
process gathers from the local payload; a round with a pair that crosses
processes all-gathers every process's payload first, unless the global
census says nobody is hungry (then every k is 0 and there is nothing to
move).  Without a group the tables are the global ones and no round
crosses, so the single-process round runs the ops it always did.
"""

from __future__ import annotations

import numpy as np
import torch

from .deque import advance_head, bottom_indices
from .lifeline import LifelineSchedule

__all__ = ["build_steal_round"]


def build_steal_round(schedule: LifelineSchedule, cfg, *, stack_cap: int, device,
                      group=None):
    """Returns steal_round(t, hungry_vec, st, any_hungry=True) -> (got, gave,
    k_given, k_recv), which runs round t mod R of the schedule: `t` is the
    superstep, a host int or a 0-d device step counter (the CUDA graph's,
    where no round crosses processes).

    `hungry_vec` [P] is the superstep's global hunger census (1 per empty
    miner); `st` is the engine carry of this process's miners, whose
    occ_stack, meta, sp and head the round updates in place.  The returned
    counters are [P_local] tensors.  `group` (a MinerGroup) splits the
    miners over processes; `any_hungry` (host bool, read only with a
    group) lets a crossing round skip its exchange when nobody is hungry.
    """
    T = cfg.steal_max
    cap = stack_cap
    if cap < T:
        raise ValueError(f"stack_cap={cap} must cover one full steal payload ({T})")
    P = schedule.n_proc
    R = schedule.n_rounds
    lo, hi = (0, P) if group is None else (group.lo, group.hi)
    PL = hi - lo
    # req_src[r, i]: the miner whose request reaches victim i in round r;
    # rep_src[r, d]: the miner whose reply reaches d; -1 when there is none
    req_src = np.full((R, P), -1, np.int64)
    rep_src = np.full((R, P), -1, np.int64)
    for r, (req_pairs, rep_pairs) in enumerate(schedule.rounds):
        for s, d in req_pairs:
            req_src[r, d] = s
        for s, d in rep_pairs:
            rep_src[r, d] = s
    # a round crosses when some miner of ANY process gets its reply from
    # another process: then every process joins the exchange
    owner = np.arange(P) // PL
    crosses = np.any((rep_src >= 0) & (owner[np.maximum(rep_src, 0)] != owner),
                     axis=1).tolist()
    req_src, rep_src = req_src[:, lo:hi], rep_src[:, lo:hi]
    # the repliers in local rows (-1 for one in another process)
    rep_local = np.where((rep_src >= lo) & (rep_src < hi), rep_src - lo, -1)
    req_src = torch.from_numpy(req_src).to(device)
    rep_local = torch.from_numpy(rep_local).to(device)
    rep_global = torch.from_numpy(rep_src).to(device) if any(crosses) else None
    rows = torch.arange(T, device=device)
    pidx = torch.arange(PL, device=device)[:, None]

    def round_row(table, t):
        """Round t's row of a [R, P] table: `t` a host int, or a 0-d
        device step counter (a gather, so one CUDA graph serves every
        round)."""
        if isinstance(t, torch.Tensor):
            return table.index_select(0, torch.remainder(t, R).view(1))[0]
        return table[t % R]

    def steal_round(t, hungry_vec, st, any_hungry: bool = True):
        if isinstance(t, torch.Tensor):
            if any(crosses):
                raise ValueError("a round that crosses processes needs the host's step")
            crossing = False
        else:
            crossing = crosses[t % R] and any_hungry
        # REQUEST, read out of the census
        requester = round_row(req_src, t)
        req_in = torch.where(requester >= 0,
                             hungry_vec[torch.clamp(requester, 0, P - 1)], 0)
        donate = (req_in > 0) & (st.sp > 1)
        k = torch.where(donate, torch.clamp(st.sp // 2, max=T), 0)
        src = bottom_indices(st.head[:, None], rows[None, :], cap)  # [P, T]
        pay_mask = (rows[None, :] < k[:, None])[..., None]
        pay_occ = torch.where(pay_mask, st.occ_stack[pidx, src], 0)
        pay_meta = torch.where(pay_mask, st.meta[pidx, src], 0)
        # the donated bottom-k leaves by pointer arithmetic
        st.head = advance_head(st.head, k, cap)
        st.sp = st.sp - k
        # GIVE/REJECT: gather each receiver's payload from its replier
        if crossing:
            k_all, pay_occ, pay_meta = group.all_gather(k, pay_occ, pay_meta)
            replier, n_src = rep_global[t % R], P
        else:
            k_all, replier, n_src = k, round_row(rep_local, t), PL
        has = replier >= 0
        rsrc = torch.clamp(replier, 0, n_src - 1)
        recv_k = torch.where(has, k_all[rsrc], 0)
        got = recv_k > 0  # only ever true for requesters (they had sp == 0)
        # a receiver is empty, so its bottom is pinned to physical row 0 and
        # the payload lands in rows [0, T)
        st.head = torch.where(got, 0, st.head)
        wmask = (rows[None, :] < recv_k[:, None])[..., None]
        st.occ_stack[:, :T] = torch.where(wmask, pay_occ[rsrc], st.occ_stack[:, :T])
        st.meta[:, :T] = torch.where(wmask, pay_meta[rsrc], st.meta[:, :T])
        st.sp = torch.where(got, recv_k, st.sp)
        return got.long(), donate.long(), k, torch.where(got, recv_k, 0)

    return steal_round
