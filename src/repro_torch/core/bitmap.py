"""Packed-bitmap transaction database (paper §4.6), host numpy + torch words.

Counterpart of `repro.core.bitmap`.  The host-side numpy parts are copies
(`pack_db`, `unpack_occ`, `full_occ`, `item_tiling`, `BitmapLayout`,
`supports_np`); the device side carries every bitmap word as an `int32`
view of the same 32 bits, because `torch.uint32` has no `>>` on the CPU:

    db_bits[j, w]   word w of item j's transaction column
    occ[..., w]     occurrence bitmap of an itemset (node payload)
    support(occ)    = sum_w popcount(occ[w])
    supports vs DB  = popcount-GEMM: S[b, j] = sum_w popcount(occ[b, w] & db[j, w])

`popcount32` widens to int64 before shifting: `>>` on a negative int32 is
an arithmetic shift, and a SWAR popcount needs the logical one.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

WORD_BITS = 32

#: default item-tile width of the database layout (the JAX package's TPU
#: tile; the CUDA kernel reads the flat [T*m_tile, W] view in one launch)
DEFAULT_ITEM_TILE = 4096

__all__ = [
    "WORD_BITS",
    "DEFAULT_ITEM_TILE",
    "BitmapLayout",
    "item_tiling",
    "num_words",
    "pack_db",
    "unpack_occ",
    "full_occ",
    "popcount_np",
    "support_np",
    "supports_np",
    "words_to_tensor",
    "tensor_to_words",
    "popcount32",
    "support_words",
]


def num_words(n_transactions: int) -> int:
    return (n_transactions + WORD_BITS - 1) // WORD_BITS


def item_tiling(m: int, max_tile: int = DEFAULT_ITEM_TILE) -> tuple[int, int]:
    """(m_pad, m_tile) for an m-item axis: single tile for small m, else m
    rounded up to a multiple of `max_tile` (padded tail items are all-zero
    columns)."""
    if m <= max_tile:
        return m, m
    n_tiles = -(-m // max_tile)
    return n_tiles * max_tile, max_tile


@dataclass(frozen=True)
class BitmapLayout:
    """Item-axis-tiled packed database: `tiles[t, r, w]` is word w of item
    `t * m_tile + r`.  Items at positions >= `m` are all-zero columns: zero
    support, never accepted, counted, emitted, or extended."""

    tiles: np.ndarray  # [T, m_tile, W] uint32, read-only
    m: int             # actual item count (tail beyond m is zero padding)

    def __post_init__(self):
        if self.tiles.ndim != 3:
            raise ValueError(f"tiles must be [T, m_tile, W], got {self.tiles.shape}")
        if not (0 <= self.m <= self.m_pad):
            raise ValueError(f"m={self.m} outside [0, {self.m_pad}]")

    @property
    def n_tiles(self) -> int:
        return self.tiles.shape[0]

    @property
    def m_tile(self) -> int:
        return self.tiles.shape[1]

    @property
    def w(self) -> int:
        return self.tiles.shape[2]

    @property
    def m_pad(self) -> int:
        return self.tiles.shape[0] * self.tiles.shape[1]

    @property
    def flat(self) -> np.ndarray:
        """[m_pad, W] item-major view (a reshape — no copy)."""
        return self.tiles.reshape(self.m_pad, self.w)

    def tail_mask(self) -> np.ndarray:
        """[m_pad] bool: True for real items, False for the padded tail."""
        return np.arange(self.m_pad) < self.m

    @classmethod
    def from_db_bits(
        cls,
        db_bits: np.ndarray,
        *,
        m: int | None = None,
        m_tile: int | None = None,
        m_pad: int | None = None,
    ) -> "BitmapLayout":
        """Tile an item-major [M, W] packed database (see
        `repro.core.bitmap.BitmapLayout.from_db_bits`)."""
        db_bits = np.asarray(db_bits, dtype=np.uint32)
        rows, w = db_bits.shape
        m = rows if m is None else m
        if m_pad is None and m_tile is None:
            m_pad, m_tile = item_tiling(max(rows, 1))
        elif m_tile is None:
            m_pad2, m_tile = item_tiling(m_pad)
            if m_pad2 != m_pad:
                raise ValueError(
                    f"m_pad={m_pad} is not a multiple of the default tile "
                    f"{m_tile}; pass m_tile explicitly"
                )
        elif m_pad is None:
            m_pad = -(-max(rows, 1) // m_tile) * m_tile
        if m_pad % m_tile != 0:
            raise ValueError(f"m_pad={m_pad} not a multiple of m_tile={m_tile}")
        if m_pad < rows:
            raise ValueError(f"m_pad={m_pad} smaller than db_bits rows={rows}")
        tiles = np.zeros((m_pad // m_tile, m_tile, w), dtype=np.uint32)
        tiles.reshape(m_pad, w)[:rows] = db_bits
        tiles.flags.writeable = False
        return cls(tiles=tiles, m=m)


def pack_db(db_bool: np.ndarray) -> np.ndarray:
    """[N_transactions, M_items] bool -> [M, W] uint32 (bit t of word w = transaction 32w+t)."""
    db_bool = np.asarray(db_bool, dtype=bool)
    n, m = db_bool.shape
    w = num_words(n)
    padded = np.zeros((w * WORD_BITS, m), dtype=bool)
    padded[:n] = db_bool
    bytes_ = np.packbits(padded, axis=0, bitorder="little")  # [W*4, M]
    words = bytes_.reshape(w, 4, m).astype(np.uint32)
    out = words[:, 0] | (words[:, 1] << 8) | (words[:, 2] << 16) | (words[:, 3] << 24)
    return np.ascontiguousarray(out.T)  # [M, W]


def unpack_occ(occ: np.ndarray, n_transactions: int) -> np.ndarray:
    """[..., W] uint32 -> [..., N] bool."""
    occ = np.asarray(occ, dtype=np.uint32)
    b0 = occ & 0xFF
    b1 = (occ >> 8) & 0xFF
    b2 = (occ >> 16) & 0xFF
    b3 = (occ >> 24) & 0xFF
    bytes_ = np.stack([b0, b1, b2, b3], axis=-1).astype(np.uint8)  # [..., W, 4]
    bits = np.unpackbits(bytes_, axis=-1, bitorder="little")  # [..., W, 32]
    bits = bits.reshape(*occ.shape[:-1], occ.shape[-1] * WORD_BITS)
    return bits[..., :n_transactions].astype(bool)


def full_occ(n_transactions: int) -> np.ndarray:
    """All-transactions occurrence bitmap with the tail bits zeroed."""
    w = num_words(n_transactions)
    occ = np.full(w, 0xFFFFFFFF, dtype=np.uint32)
    tail = n_transactions % WORD_BITS
    if tail:
        occ[-1] = np.uint32((1 << tail) - 1)
    return occ


# ------------------------------------------------------------------ numpy path
def popcount_np(x: np.ndarray) -> np.ndarray:
    return np.bitwise_count(x)


def support_np(occ: np.ndarray) -> np.ndarray:
    """[..., W] -> [...] int32 popcount sum."""
    return popcount_np(occ).sum(axis=-1).astype(np.int32)


def supports_np(occ: np.ndarray, db_bits: np.ndarray) -> np.ndarray:
    """Popcount-GEMM oracle. occ [..., W], db_bits [M, W] -> [..., M] int32."""
    inter = occ[..., None, :] & db_bits  # [..., M, W]
    return popcount_np(inter).sum(axis=-1).astype(np.int32)


# ------------------------------------------------------------------ torch path
def words_to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy words -> an int32 tensor on `device` holding the same bits."""
    a = np.array(words, dtype=np.uint32, copy=True, order="C")
    return torch.from_numpy(a.view(np.int32)).to(device)


def tensor_to_words(t: torch.Tensor) -> np.ndarray:
    """int32 tensor of bitmap words -> uint32 numpy array of the same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 bitmap words (SWAR on int64) -> int32.

    In place on one int64 temporary: on the CPU that is ~2.4x faster than
    the out-of-place chain at the engine's [16, 1191, 22] shape.
    """
    v = x.to(torch.int64).bitwise_and_(0xFFFFFFFF)  # the 32 bits, unsigned
    t = (v >> 1).bitwise_and_(0x55555555)
    v.sub_(t)
    t = (v >> 2).bitwise_and_(0x33333333)
    v.bitwise_and_(0x33333333).add_(t)
    v.add_(v >> 4).bitwise_and_(0x0F0F0F0F)
    v.mul_(0x01010101).bitwise_right_shift_(24).bitwise_and_(0xFF)
    return v.to(torch.int32)


def support_words(occ: torch.Tensor) -> torch.Tensor:
    """[..., W] int32 words -> [...] int32 support (popcount sum)."""
    return popcount32(occ).sum(dim=-1, dtype=torch.int32)
