"""The plain PyTorch version of the support-count kernel.

Counterpart of `repro.kernels.support_count.ref` (which takes the
word-major transpose); this one reads the item-major `[M, W]` database, as
the CUDA kernel does.  The CPU tests run it, and `chip_smoke.py` holds the
kernel against it on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.bitmap import popcount32

#: elements of the [rows, M, W] intersection materialised at once (the
#: int64 SWAR temporaries are 8 bytes each)
_CHUNK_ELEMS = 1 << 23


def support_count_ref(occ: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """occ [B, W] int32, db [M, W] int32 (item-major) -> [B, M] int32.

    S[b, j] = sum_w popcount(occ[b, w] & db[j, w]), swept over row chunks
    so the intersection never holds more than `_CHUNK_ELEMS` words.
    """
    b, w = occ.shape
    m = db.shape[0]
    out = torch.empty((b, m), dtype=torch.int32, device=occ.device)
    rows = max(1, _CHUNK_ELEMS // max(m * w, 1))
    for lo in range(0, b, rows):
        inter = occ[lo:lo + rows, None, :] & db[None, :, :]  # [rows, M, W]
        out[lo:lo + rows] = popcount32(inter).sum(dim=-1, dtype=torch.int32)
    return out
