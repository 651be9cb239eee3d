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
kept in the signatures for parity with the JAX package, where it picks the
Pallas block shape; the CUDA kernel's tile is fixed, so only None is taken.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitmap import item_tiling, words_to_tensor
from repro_torch.device import resolve_device

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


def _no_blocks(blocks):
    if blocks is not None:
        raise ValueError(
            "the CUDA support-count kernel has a fixed tile; blocks must be None"
        )


def _count(occ: torch.Tensor, db: torch.Tensor, impl: str) -> torch.Tensor:
    if occ.shape[1] != db.shape[1]:
        raise ValueError(f"word widths differ: occ {tuple(occ.shape)}, db {tuple(db.shape)}")
    if impl == "cuda":
        return kernel.support_count_cuda(occ.contiguous(), db.contiguous())
    if impl == "ref":
        return support_count_ref(occ, db)
    raise ValueError(f"unresolved kernel impl {impl!r}")


def tile_counts(occ: torch.Tensor, tile_mw: torch.Tensor, *, impl: str,
                blocks=None) -> torch.Tensor:
    """One tile: occ [B, W] x tile [m_tile, W] -> [B, m_tile] int32."""
    _no_blocks(blocks)
    return _count(occ, tile_mw, impl)


def support_counts_tiled(occ: torch.Tensor, db_tiles: torch.Tensor, *,
                         impl: str, blocks=None) -> torch.Tensor:
    """occ [B, W] x db_tiles [T, m_tile, W] -> [B, T*m_tile] int32.

    The engine's EXPAND entry.  With the CUDA kernel this is one launch
    over the flat [T*m_tile, W] view — the tiles were a TPU VMEM device and
    the output is identical.  The plain version sweeps tile by tile, which
    bounds its memory on the CPU.
    """
    _no_blocks(blocks)
    t, mt, w = db_tiles.shape
    if impl == "cuda":
        return _count(occ, db_tiles.reshape(t * mt, w), impl)
    return torch.cat([tile_counts(occ, db_tiles[i], impl=impl) for i in range(t)], dim=1)


def support_counts(occ, db_bits, *, impl: str = "auto", blocks=None,
                   m_tile: int | None = None, device=None) -> torch.Tensor:
    """Support of every item against every bitmap: [B, W] x [M, W] -> [B, M].

    The public eager wrapper (closure reconstruction, tests).  Tensors are
    used where they lie; numpy uint32 words are uploaded to `device`
    (default: the card, see `repro_torch.resolve_device`).  `m_tile` sets
    the item tile the plain version sweeps (default `item_tiling`'s).
    """
    _no_blocks(blocks)
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
    if impl == "cuda":
        return _count(occ, db_bits, impl)
    mt = m_tile if m_tile is not None else item_tiling(max(m, 1))[1]
    if m == 0:
        return torch.zeros((b, 0), dtype=torch.int32, device=dev)
    return torch.cat(
        [_count(occ, db_bits[lo:lo + mt], impl) for lo in range(0, m, mt)], dim=1
    )
