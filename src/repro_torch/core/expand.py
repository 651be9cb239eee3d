"""Superstep phase 1 — EXPAND: popcount-GEMM expansion + deferred-PPC.

Counterpart of `repro.core.expand`, batched over the P miners that share
the device as the leading tensor dim.  Each miner pops up to
`expand_batch` nodes; one popcount-GEMM over all P*B popped rows
(`ops.support_counts_tiled`, the CUDA kernel on the card) gives every extension's
support; then deferred-PPC validation, closed-set counting, pattern-record
emission (modes "test"/"count2d"), 2-D histogram accumulation
(mode="count2d"), child generation and the resume-node path for parents
whose children overflowed the per-superstep push cap.

Every order the JAX version fixes is kept bit for bit, because the stats
and the records follow from it:

* pop order: the top B nodes, top-first (`deque.top_indices`);
* emission order: a miner's significant rows in ascending row order, the
  order `jnp.nonzero(size=B)` gives;
* candidate compaction: cumsum over the flat [B*m] candidate mask, then
  `searchsorted(side="left")` for the 1st..C-th set bit, ascending (here
  batched over [P, B*m], the sorted sequence and the values both int32);
* the child block is contiguous above `sp_after`;
* a resume node continues at the first candidate not pushed (`argmax` over
  an integer cast of the mask returns the first maximal index).

The JAX version's `mode="drop"` scatters write into spill rows here: row
CAP of the stacks and row out_cap of the record buffers.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.support_count.ops import support_counts_tiled
from repro_torch.stats import get_statistic

from .bitmap import support_words
from .deque import push_positions, top_indices
from .stats import Stat

__all__ = ["build_expand"]


def build_expand(*, n: int, n_pos: int, m: int, cfg, stack_cap: int,
                 mode: str, kernel_impl: str, statistic: str | None = "fisher"):
    """Returns expand(st, db_tiles, pos_mask, delta, n_act, npos_act) -> sig_cnt [P].

    `st` is the engine's carry (core.engine._Carry); expand updates its
    occ_stack, meta, sp, hist, hist2d, stats, out_occ, out_meta and out_ptr
    in place.  `n`, `n_pos`, `m` are the program dims (padded items have
    zero support, so they are never accepted, counted, emitted or pushed).
    """
    B, CAP, C = cfg.expand_batch, stack_cap, cfg.push_cap
    OUT = cfg.out_cap
    kernel_blocks = cfg.kernel_blocks
    NB = n + 2
    hist2d_mode = mode == "count2d"
    emitting = mode in ("test", "count2d")
    pvalue_device = (
        get_statistic(statistic).pvalue_device if statistic is not None else None
    )

    def expand(st, db_tiles, pos_mask, delta, n_act, npos_act):
        dev = st.sp.device
        P = st.sp.shape[0]
        assert db_tiles.shape[0] * db_tiles.shape[1] == m, (db_tiles.shape, m)
        db_flat = db_tiles.reshape(m, db_tiles.shape[2])  # [m, W] view
        pidx = torch.arange(P, device=dev)[:, None]
        rows = torch.arange(B, device=dev)
        take = torch.clamp(st.sp, max=B)
        node_idx = top_indices(st.head[:, None], st.sp[:, None], rows[None, :], CAP)
        row_valid = rows[None, :] < take[:, None]
        occ_nodes = st.occ_stack[pidx, node_idx]      # [P, B, W]
        meta_nodes = st.meta[pidx, node_idx]          # [P, B, 4]
        core, pc, sup, flags = meta_nodes.unbind(-1)
        sp_after = st.sp - take

        alive = row_valid & (sup >= st.lam)
        w = occ_nodes.shape[-1]
        supports = support_counts_tiled(
            occ_nodes.reshape(P * B, w), db_tiles, impl=kernel_impl,
            blocks=kernel_blocks,
        ).view(P, B, m)
        item_ids = torch.arange(m, device=dev)
        in_clo = supports == sup[..., None]
        prefix_ct = torch.sum(in_clo & (item_ids < core[..., None]), dim=-1)
        is_resume = (flags & 1) == 1
        ppc_ok = is_resume | (core < 0) | (prefix_ct == pc)
        accepted = alive & ppc_ok
        counted = accepted & ~is_resume

        st.hist.scatter_add_(1, torch.clamp(sup, 0, NB - 1).long(), counted.long())

        sig_cnt = torch.zeros(P, dtype=torch.int64, device=dev)
        if emitting:
            pos_sup = support_words(occ_nodes & pos_mask)  # [P, B]
            if hist2d_mode:
                cell = (torch.clamp(sup, 0, n).long() * (n_pos + 1)
                        + torch.clamp(pos_sup, 0, n_pos).long())
                st.hist2d.scatter_add_(1, cell, counted.long())
            if pvalue_device is None:
                sig = counted
            else:
                pvals = pvalue_device(
                    sup.reshape(-1), pos_sup.reshape(-1), n_act, npos_act, k_max=n_pos
                ).view(P, B)
                sig = counted & (pvals <= delta)
            sig_cnt = sig.sum(dim=1)
            rank = torch.cumsum(sig.long(), dim=1) - 1
            pos = st.out_ptr[:, None] + rank
            dst = torch.where(sig & (pos < OUT), pos, torch.full_like(pos, OUT))
            st.out_occ[pidx, dst] = occ_nodes
            st.out_meta[pidx, dst] = torch.stack([core, sup, pos_sup], dim=-1)
            # emissions past out_cap land in the spill row; count them
            st.stats[:, Stat.EMIT_DROPPED] += torch.clamp(
                st.out_ptr + sig_cnt - OUT, min=0
            )
            st.out_ptr = torch.clamp(st.out_ptr + sig_cnt, max=OUT)

        # ---- children
        cand = (
            accepted[..., None]
            & (item_ids > core[..., None])
            & (supports < sup[..., None])
            & (supports >= st.lam)
        )                                              # [P, B, m]
        in_clo_i = in_clo.to(torch.int32)
        clo_cum_excl = torch.cumsum(in_clo_i, dim=-1, dtype=torch.int32) - in_clo_i
        cand_i = cand.to(torch.int32)
        cand_cum = torch.cumsum(cand_i.view(P, B * m), dim=1, dtype=torch.int32)
        n_taken = torch.clamp(cand_cum[:, -1].long(), max=C)  # children pushed
        # index of the (c+1)-th set bit, ascending — nonzero's order exactly
        targets = torch.arange(1, C + 1, device=dev, dtype=torch.int32)
        cand_idx = torch.searchsorted(
            cand_cum, targets.expand(P, C).contiguous(), side="left"
        )
        cand_idx = torch.clamp(cand_idx, max=B * m - 1)
        child_b = torch.clamp(cand_idx // m, 0, B - 1)
        child_j = torch.clamp(cand_idx % m, 0, m - 1)
        child_occ = occ_nodes[pidx, child_b] & db_flat[child_j]  # [P, C, W]
        child_meta = torch.stack(
            [
                child_j.to(torch.int32),
                clo_cum_excl[pidx, child_b, child_j],
                supports[pidx, child_b, child_j],
                torch.zeros_like(child_j, dtype=torch.int32),
            ],
            dim=-1,
        )
        # the compacted child block is contiguous above sp_after: child c
        # goes to logical slot sp_after + c; pushes past CAP go to the spill
        # row (an overflow is fatal in postprocess anyway)
        c_idx = torch.arange(C, device=dev)
        logical = sp_after[:, None] + c_idx[None, :]
        in_push = (c_idx[None, :] < n_taken[:, None]) & (logical < CAP)
        dst = torch.where(in_push, torch.remainder(st.head[:, None] + logical, CAP),
                          torch.full_like(logical, CAP))
        st.occ_stack[pidx, dst] = child_occ
        st.meta[pidx, dst] = child_meta
        overflow = sp_after + n_taken > CAP
        sp2 = torch.clamp(sp_after + n_taken, max=CAP)

        # ---- resume parents whose children overflowed the push cap
        row_counts = cand_i.sum(dim=-1)                         # [P, B]
        row_offset = torch.cumsum(row_counts, dim=1) - row_counts
        taken_per_row = torch.minimum(torch.clamp(C - row_offset, min=0), row_counts)
        needs_resume = accepted & (taken_per_row < row_counts)
        # within-row exclusive cumsum, read off the flat inclusive one
        pos_in_row = (cand_cum.view(P, B, m) - row_offset[..., None].to(torch.int32)
                      - cand_i)
        first_untaken = cand & (pos_in_row == taken_per_row[..., None])
        cursor = torch.argmax(first_untaken.to(torch.uint8), dim=-1)  # first max
        res_meta = torch.stack(
            [
                (cursor - 1).to(torch.int32),
                torch.zeros_like(sup),
                sup,
                torch.ones_like(sup),
            ],
            dim=-1,
        )
        res_pos, res_overflow = push_positions(
            st.head, sp2, torch.cumsum(needs_resume.long(), dim=1) - 1,
            needs_resume, CAP,
        )
        overflow = overflow | res_overflow
        st.occ_stack[pidx, res_pos] = occ_nodes
        st.meta[pidx, res_pos] = res_meta
        st.sp = torch.clamp(sp2 + needs_resume.sum(dim=1), max=CAP)

        st.stats[:, Stat.POPPED] += alive.sum(dim=1)
        st.stats[:, Stat.REJECTED] += (alive & ~ppc_ok).sum(dim=1)
        st.stats[:, Stat.CLOSED] += counted.sum(dim=1)
        st.stats[:, Stat.PUSHED] += n_taken
        st.stats[:, Stat.OVERFLOW] += overflow.long()
        return sig_cnt

    return expand
