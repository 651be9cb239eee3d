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
"""

from __future__ import annotations

import numpy as np
import torch

from .deque import advance_head, bottom_indices
from .lifeline import LifelineSchedule

__all__ = ["build_steal_round"]


def build_steal_round(schedule: LifelineSchedule, cfg, *, stack_cap: int, device):
    """Returns steal_round(t, hungry_vec, st) -> (got, gave, k_given, k_recv).

    `hungry_vec` [P] is the superstep's hunger census (1 per empty miner);
    `st` is the engine carry, whose occ_stack, meta, sp and head the round
    updates in place.  The returned counters are [P] tensors.
    """
    T = cfg.steal_max
    cap = stack_cap
    if cap < T:
        raise ValueError(f"stack_cap={cap} must cover one full steal payload ({T})")
    P = schedule.n_proc
    R = schedule.n_rounds
    # req_src[r, i]: the miner whose request reaches victim i in round r;
    # rep_src[r, d]: the miner whose reply reaches d; -1 when there is none
    req_src = np.full((R, P), -1, np.int64)
    rep_src = np.full((R, P), -1, np.int64)
    for r, (req_pairs, rep_pairs) in enumerate(schedule.rounds):
        for s, d in req_pairs:
            req_src[r, d] = s
        for s, d in rep_pairs:
            rep_src[r, d] = s
    req_src = torch.from_numpy(req_src).to(device)
    rep_src = torch.from_numpy(rep_src).to(device)
    rows = torch.arange(T, device=device)
    pidx = torch.arange(P, device=device)[:, None]

    def steal_round(t: int, hungry_vec, st):
        r = t % R
        # REQUEST, read out of the census
        requester = req_src[r]
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
        replier = rep_src[r]
        has = replier >= 0
        rsrc = torch.clamp(replier, 0, P - 1)
        recv_k = torch.where(has, k[rsrc], 0)
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
