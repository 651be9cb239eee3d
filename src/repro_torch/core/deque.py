"""Circular work deque over fixed [CAP, ...] storage (counterpart of
`repro.core.deque`).

Each miner's stack addresses its storage circularly through two scalars:

    head  physical row of the logical bottom (slot 0, the oldest node)
    sp    live node count; logical slot i lives at (head + i) % cap

EXPAND pops and pushes at the logical top by pointer arithmetic; a steal
donates the logical bottom-k and advances `head`.  In the port the P miners'
stacks are one [P, CAP + 1, ...] tensor: `head` and `sp` are [P] tensors,
the helpers broadcast over the leading miner dim, and row CAP is a spill
row that takes the writes the JAX package drops with `mode="drop"` (no
logical slot ever maps to it, since every slot is taken `% cap`).
"""

from __future__ import annotations

import torch

__all__ = [
    "advance_head",
    "bottom_indices",
    "push_positions",
    "top_indices",
]


def top_indices(head, sp, rows, cap: int):
    """Physical rows of the top ``len(rows)`` nodes, top-first.

    Offsets past the bottom wrap to in-range garbage rows; callers mask
    with ``rows < sp``.
    """
    return torch.remainder(head + sp - 1 - rows, cap)


def bottom_indices(head, rows, cap: int):
    """Physical rows of the bottom ``len(rows)`` nodes, bottom-first."""
    return torch.remainder(head + rows, cap)


def push_positions(head, base_sp, offsets, valid, cap: int):
    """Scatter rows for pushing ``offsets``-th new nodes above ``base_sp``.

    Returns ``(pos, overflow)``: physical rows for valid, in-capacity pushes
    and ``cap`` (the spill row) for the rest; ``overflow`` [P] is True for a
    miner whose valid push did not fit.  `head`/`base_sp` are [P]; offsets
    and valid are [P, K].
    """
    logical = base_sp[:, None] + offsets
    fits = logical < cap
    overflow = torch.any(valid & ~fits, dim=1)
    pos = torch.where(valid & fits, torch.remainder(head[:, None] + logical, cap),
                      torch.full_like(logical, cap))
    return pos, overflow


def advance_head(head, k, cap: int):
    """Consume the bottom-k nodes (a donation): slide the bottom pointer."""
    return torch.remainder(head + k, cap)
