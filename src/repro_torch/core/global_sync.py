"""Superstep phase 3 — GLOBAL: hunger census, periodic lambda sync, termination.

Counterpart of `repro.core.global_sync`, over the P miners of one device:
every `psum` over the miners axis is a sum over dim 0.

`hunger_census` is the [P] vector of "my stack is empty" bits; its sum is
the steal gate and `n_hungry == P` the exact BSP termination test.  Mode
"lamp1" additionally folds the *since-last-sync delta* of the per-miner
support histograms into the global one every `sync_period` supersteps and
recomputes lambda (paper §4.4; staleness only costs work, never
correctness).  The step counter is uniform across miners, so the JAX
version's `lax.cond` on `(t + 1) % sync_period` is a Python `if` here.

`recompute_lambda` serves both the device update (torch) and the host
replay in `engine.postprocess_phase` (numpy).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["hunger_census", "recompute_lambda", "build_global_sync"]


def hunger_census(sp: torch.Tensor) -> torch.Tensor:
    """[P] int64: 1 for each miner whose stack is empty right now."""
    return (sp == 0).long()


def recompute_lambda(g_hist, thr, lam):
    """Largest lambda with CS(lambda) <= thr, never decreasing (paper §3.2).

    g_hist [NB] global closed-set histogram, thr [NB] integer Tarone
    thresholds, lam the current lambda — all torch tensors, or all numpy.
    """
    if isinstance(g_hist, torch.Tensor):
        nb = g_hist.shape[0]
        cs = torch.flip(torch.cumsum(torch.flip(g_hist, [0]), 0), [0])
        ids = torch.arange(nb, device=g_hist.device)
        best = torch.max(torch.where(cs > thr, ids, 0))
        return torch.clamp(torch.maximum(lam, best + 1), min=1)
    nb = g_hist.shape[0]
    cs = np.cumsum(g_hist[::-1])[::-1]  # cs[x] = #closed with sup >= x
    best = np.max(np.where(cs > thr, np.arange(nb), 0))
    return np.maximum(np.maximum(lam, best + 1), 1)


def build_global_sync(*, mode: str, sync_period: int = 1):
    """Returns global_sync(t, st, thr), updating st.lam, st.g_hist_acc and
    st.hist_snap in place; the identity for modes other than "lamp1"."""
    if sync_period < 1:
        raise ValueError(f"sync_period must be >= 1, got {sync_period}")

    def global_sync(t: int, st, thr):
        if mode != "lamp1" or (t + 1) % sync_period != 0:
            return
        st.g_hist_acc = st.g_hist_acc + (st.hist - st.hist_snap).sum(dim=0)
        st.lam = recompute_lambda(st.g_hist_acc, thr, st.lam)
        st.hist_snap = st.hist.clone()

    return global_sync
