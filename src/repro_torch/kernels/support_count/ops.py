"""THE dispatch point for support counting (counterpart of
`repro.kernels.support_count.ops`).

Every support count of the port — the engine's EXPAND phase and host-side
closure reconstruction — goes through this module.  Variants:

  ref    the plain PyTorch version (`ref.support_count_ref`)
  cuda   the hand-written CUDA kernel (`kernel.support_count_cuda`)

"auto" resolves by where the tensors lie: `cuda` for CUDA tensors, `ref`
for CPU ones.  `cuda` on a CPU tensor raises; `ref` on a CUDA tensor is
allowed (it is the plain version the kernel is held against).

The database argument is item-major `[M, W]` (`pack_db`'s layout and the
flat view of `core.bitmap.BitmapLayout`).  No padding is needed: zero words
count nothing, and the kernel masks its ragged edges itself.  `blocks` is
the kernel's (block_b, block_m, block_w) tile (`autotune.py`): None lets
`autotune.choose_blocks` pick it at the launch's exact shape.  The plain
version has no tile and ignores `blocks`, as the JAX package's ref does.

Every call of the three entries is one support-count work item of
`launch.op_cost`: with a cost count active, the item is recorded by its
shapes and the count runs outside the dispatch mode, so the report is the
same whichever impl runs and however it sweeps the tiles.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitmap import item_tiling, words_to_tensor
from repro_torch.device import resolve_device
from repro_torch.launch.op_cost import support_count_item

from . import kernel
from .ref import support_count_ref

__all__ = [
    "VALID_IMPLS",
    "resolve_impl",
    "support_counts",
    "support_counts_tiled",
    "tile_counts",
]

#: concrete kernel variants ("auto" resolves per device via `resolve_impl`)
VALID_IMPLS = ("ref", "cuda")


def resolve_impl(impl: str, device) -> str:
    """Resolve "auto" against the device the tensors lie on."""
    dev = torch.device(device)
    if impl == "auto":
        return "cuda" if dev.type == "cuda" else "ref"
    if impl not in VALID_IMPLS:
        raise ValueError(
            f"unknown kernel impl {impl!r}; valid: auto, {', '.join(VALID_IMPLS)}"
        )
    if impl == "cuda" and dev.type != "cuda":
        raise ValueError(f"kernel impl 'cuda' needs CUDA tensors, got device {dev}")
    return impl


def _count(occ: torch.Tensor, db: torch.Tensor, impl: str,
           blocks=None) -> torch.Tensor:
    if occ.shape[1] != db.shape[1]:
        raise ValueError(f"word widths differ: occ {tuple(occ.shape)}, db {tuple(db.shape)}")
    if impl == "cuda":
        return kernel.support_count_cuda(occ.contiguous(), db.contiguous(), blocks)
    if impl == "ref":
        return support_count_ref(occ, db)
    raise ValueError(f"unresolved kernel impl {impl!r}")


def tile_counts(occ: torch.Tensor, tile_mw: torch.Tensor, *, impl: str,
                blocks=None) -> torch.Tensor:
    """One tile: occ [B, W] x tile [m_tile, W] -> [B, m_tile] int32."""
    with support_count_item(occ.shape[0], tile_mw.shape[0], tile_mw.shape[1]):
        return _count(occ, tile_mw, impl, blocks)


def support_counts_tiled(occ: torch.Tensor, db_tiles: torch.Tensor, *,
                         impl: str, blocks=None) -> torch.Tensor:
    """occ [B, W] x db_tiles [T, m_tile, W] -> [B, T*m_tile] int32.

    The engine's EXPAND entry.  With the CUDA kernel this is one launch
    over the flat [T*m_tile, W] view — the tiles were a TPU VMEM device and
    the output is identical.  The plain version sweeps tile by tile, which
    bounds its memory on the CPU.
    """
    t, mt, w = db_tiles.shape
    with support_count_item(occ.shape[0], t * mt, w):
        if impl == "cuda":
            return _count(occ, db_tiles.reshape(t * mt, w), impl, blocks)
        return torch.cat([_count(occ, db_tiles[i], impl) for i in range(t)], dim=1)


def support_counts(occ, db_bits, *, impl: str = "auto", blocks=None,
                   m_tile: int | None = None, device=None) -> torch.Tensor:
    """Support of every item against every bitmap: [B, W] x [M, W] -> [B, M].

    The public eager wrapper (closure reconstruction, tests).  Tensors are
    used where they lie; numpy uint32 words are uploaded to `device`
    (default: the card, see `repro_torch.resolve_device`).  `m_tile` sets
    the item tile the plain version sweeps (default `item_tiling`'s).
    """
    if isinstance(occ, torch.Tensor):
        dev = occ.device
    else:
        dev = resolve_device(device)
        occ = words_to_tensor(np.asarray(occ), dev)
    if not isinstance(db_bits, torch.Tensor):
        db_bits = words_to_tensor(np.asarray(db_bits), dev)
    impl = resolve_impl(impl, dev)
    b = occ.shape[0]
    m = db_bits.shape[0]
    with support_count_item(b, m, db_bits.shape[1]):
        if impl == "cuda":
            return _count(occ, db_bits, impl, blocks)
        mt = m_tile if m_tile is not None else item_tiling(max(m, 1))[1]
        if m == 0:
            return torch.zeros((b, 0), dtype=torch.int32, device=dev)
        return torch.cat(
            [_count(occ, db_bits[lo:lo + mt], impl) for lo in range(0, m, mt)], dim=1
        )
