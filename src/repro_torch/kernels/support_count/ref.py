"""The plain PyTorch version of the support-count kernel.

Counterpart of `repro.kernels.support_count.ref` (which takes the
word-major transpose); this one reads the item-major `[M, W]` database, as
the CUDA kernel does.  The CPU tests run it, and `chip_smoke.py` holds the
kernel against it on the card.

`unpack_bits_int8` turns words into {0, 1} int8 rows, so that one integer
matrix product (`torch._int_mm`) computes the same S.  Only the tests and
`chip_smoke.py` use it, to time that call as the kernel's library yardstick;
the port never counts that way.
"""

from __future__ import annotations

import torch

from repro_torch.core.bitmap import WORD_BITS, popcount32

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


def unpack_bits_int8(words: torch.Tensor) -> torch.Tensor:
    """[rows, W] int32 words -> [rows, 32*W] int8 of {0, 1}: column
    32*w + i holds bit i of word w.  Then S = occ_u8 @ db_u8.T."""
    shifts = torch.arange(WORD_BITS, device=words.device, dtype=torch.int32)
    bits = (words[:, :, None] >> shifts).bitwise_and_(1)  # [rows, W, 32]
    return bits.reshape(words.shape[0], -1).to(torch.int8)
