"""Dataset — an immutable prepared mining input (counterpart of
`repro.api.dataset`).

A `Dataset` is the unit a `MinerSession` queries: the occurrence bitmap is
packed exactly **once** at construction (`core.engine.pack_problem`),
padded up to a *shape bucket*, uploaded to its device and reused by every
phase of every query, closure reconstruction included.  The bucket —
(transactions, positives, items) each rounded up to a configured grid — is
the shape part of the session's program cache key: padding is all zero
bits, zero-support items can never be accepted, counted, emitted, or
generate children, so results are invariant to it, and any two datasets
that land in the same bucket share the session's programs.

Every constructor takes `device=` (default: the card, through
`repro_torch.resolve_device`, which raises without one); a session only
mines datasets that lie on its own device.

Constructors: `from_dense` (bool matrix), `from_packed_words` (item-major
uint32 words), `from_transactions` (lists of items, int ids or string
tokens), `from_tsv` (label + item tokens per line), `from_paper_problem`
(the Table-1 synthetic generator, with planted signal carried along) and
`placeholder` (a zero dataset shaped like a bucket).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.bitmap import DEFAULT_ITEM_TILE, item_tiling, num_words
from repro_torch.core.engine import PackedProblem, pack_problem, pack_problem_from_bits
from repro_torch.device import resolve_device

__all__ = [
    "BucketPolicy",
    "DEFAULT_BUCKETS",
    "EXACT_BUCKETS",
    "ShapeBucket",
    "Dataset",
]


@dataclass(frozen=True)
class ShapeBucket:
    """Program dims a dataset is padded to — the shape half of a cache key.

    `item_tile` is the item-axis tile width of the database layout: 0 means
    one tile spanning all `items`, nonzero means `items` is a multiple of
    it.  The CUDA kernel reads all tiles in one launch; the plain version
    sweeps them one by one.
    """

    transactions: int  # n_pad
    positives: int     # npos_pad
    items: int         # m_pad (a multiple of item_tile when tiled)

    item_tile: int = 0  # 0 = single tile of width `items`

    @property
    def tile(self) -> int:
        """Concrete tile width (the per-sweep item extent)."""
        return self.item_tile or self.items

    @property
    def n_tiles(self) -> int:
        return self.items // self.tile if self.items else 1

    @property
    def words(self) -> int:
        return num_words(self.transactions)


@dataclass(frozen=True)
class BucketPolicy:
    """How dataset dims round up to shared program shapes.

    Geometric buckets (default ×2 from per-dim floors) bound padding waste
    at `growth`× while collapsing the space of dataset shapes onto a few
    dozen buckets.  `exact=True` disables padding (every dataset gets its
    own program shapes).
    """

    min_transactions: int = 64
    min_positives: int = 16
    min_items: int = 64
    growth: float = 2.0
    exact: bool = False
    #: item-tile width cap: item dims past this are stored tiled (rounded
    #: up to a tile multiple).  Applies to exact buckets too.
    item_tile: int = DEFAULT_ITEM_TILE

    def _round(self, value: int, floor: int) -> int:
        if value <= floor:
            return floor
        steps = math.ceil(math.log(value / floor) / math.log(self.growth))
        return math.ceil(floor * self.growth ** steps)

    def bucket_for(self, n: int, n_pos: int, m: int) -> ShapeBucket:
        if self.exact:
            m_pad, tile = item_tiling(m, self.item_tile)
            return ShapeBucket(
                transactions=n, positives=n_pos, items=m_pad,
                item_tile=tile if m_pad > tile else 0,
            )
        m_pad, tile = item_tiling(self._round(m, self.min_items), self.item_tile)
        return ShapeBucket(
            transactions=self._round(n, self.min_transactions),
            positives=self._round(n_pos, self.min_positives),
            items=m_pad,
            item_tile=tile if m_pad > tile else 0,
        )


DEFAULT_BUCKETS = BucketPolicy()
EXACT_BUCKETS = BucketPolicy(exact=True)


def _frozen_labels(labels, n: int) -> np.ndarray | None:
    if labels is None:
        return None
    labels = np.asarray(labels, dtype=bool)
    if labels.shape != (n,):
        raise ValueError(f"labels must be [{n}], got {labels.shape}")
    labels = labels.copy()
    labels.flags.writeable = False
    return labels


def _item_names(item_names, m: int) -> tuple[str, ...] | None:
    if item_names is None:
        return None
    item_names = tuple(str(s) for s in item_names)
    if len(item_names) != m:
        raise ValueError(f"item_names has {len(item_names)} entries for {m} items")
    return item_names


class Dataset:
    """Immutable prepared input: packed bitmaps + labels + names + bucket."""

    def __init__(
        self,
        db_bool: np.ndarray,
        labels: np.ndarray | None = None,
        *,
        item_names: "tuple[str, ...] | list[str] | None" = None,
        name: str = "dataset",
        bucket_policy: BucketPolicy = DEFAULT_BUCKETS,
        planted: "list[list[int]] | None" = None,
        device=None,
    ):
        db_bool = np.asarray(db_bool, dtype=bool)
        if db_bool.ndim != 2:
            raise ValueError(f"db_bool must be [transactions, items], got {db_bool.shape}")
        n, m = db_bool.shape
        labels = _frozen_labels(labels, n)
        n_pos = int(labels.sum()) if labels is not None else max(1, n // 2)
        bucket = bucket_policy.bucket_for(n, n_pos, m)
        self.name = str(name)
        self.labels = labels
        self.item_names = _item_names(item_names, m)
        self.planted = planted
        self.bucket = bucket
        # the one and only pack of this database (threaded through every
        # phase and through results reconstruction)
        self.packed: PackedProblem = pack_problem(
            db_bool,
            labels,
            n_pad=bucket.transactions,
            npos_pad=bucket.positives,
            m_pad=bucket.items,
            m_tile=bucket.tile,
            device=resolve_device(device),
        )

    # ------------------------------------------------------------ properties
    @property
    def n_transactions(self) -> int:
        return self.packed.n

    @property
    def n_items(self) -> int:
        return self.packed.m

    @property
    def n_pos(self) -> int:
        return self.packed.n_pos

    @property
    def db_bits(self) -> np.ndarray:
        """[m_pad, w_pad] u32 packed occurrence bitmap (read-only, host)."""
        return self.packed.db_bits

    def __repr__(self) -> str:
        return (
            f"Dataset({self.name!r}, {self.n_items} items x "
            f"{self.n_transactions} transactions, n_pos={self.n_pos}, "
            f"bucket=({self.bucket.transactions}, {self.bucket.positives}, "
            f"{self.bucket.items}), device={self.packed.device})"
        )

    # ---------------------------------------------------------- constructors
    @classmethod
    def placeholder(cls, bucket: ShapeBucket, *, name: str = "warmup",
                    device=None) -> "Dataset":
        """A minimal labelled dataset padded into exactly `bucket`: two
        transactions (one positive), one item, all-zero bits.  Programs
        depend on the bucket dims and config only, so it stands in for any
        dataset of the bucket."""
        if not isinstance(bucket, ShapeBucket):
            raise TypeError(
                f"placeholder() takes a ShapeBucket, got {type(bucket).__name__}"
            )
        n = min(2, bucket.transactions)
        if n < 1 or bucket.positives < 1:
            raise ValueError(f"bucket too small to placeholder: {bucket}")
        labels = np.zeros(n, dtype=bool)
        labels[0] = True
        labels.flags.writeable = False
        ds = cls.__new__(cls)
        ds.name = str(name)
        ds.labels = labels
        ds.item_names = None
        ds.planted = None
        ds.bucket = bucket
        ds.packed = pack_problem(
            np.zeros((n, 1), dtype=bool),
            labels,
            n_pad=bucket.transactions,
            npos_pad=bucket.positives,
            m_pad=bucket.items,
            m_tile=bucket.tile,
            device=resolve_device(device),
        )
        return ds

    @classmethod
    def from_dense(
        cls,
        db_bool: np.ndarray,
        labels: np.ndarray | None = None,
        *,
        item_names=None,
        name: str = "dense",
        bucket_policy: BucketPolicy = DEFAULT_BUCKETS,
        planted=None,
        device=None,
    ) -> "Dataset":
        """Prepare a dense [transactions, items] bool matrix."""
        return cls(db_bool, labels, item_names=item_names, name=name,
                   bucket_policy=bucket_policy, planted=planted, device=device)

    @classmethod
    def from_packed_words(
        cls,
        db_bits: np.ndarray,
        labels: np.ndarray | None = None,
        *,
        n_transactions: int,
        item_names=None,
        name: str = "packed",
        bucket_policy: BucketPolicy = DEFAULT_BUCKETS,
        planted=None,
        device=None,
    ) -> "Dataset":
        """Prepare an already word-packed [items, words] uint32 database
        (the paper-scale entry: no dense [transactions, items] matrix).
        `n_transactions` cannot be recovered from packed words, so it is
        required."""
        db_bits = np.asarray(db_bits, dtype=np.uint32)
        if db_bits.ndim != 2:
            raise ValueError(f"db_bits must be [items, words], got {db_bits.shape}")
        m = db_bits.shape[0]
        n = int(n_transactions)
        labels = _frozen_labels(labels, n)
        n_pos = int(labels.sum()) if labels is not None else max(1, n // 2)
        bucket = bucket_policy.bucket_for(n, n_pos, m)
        ds = cls.__new__(cls)
        ds.name = str(name)
        ds.labels = labels
        ds.item_names = _item_names(item_names, m)
        ds.planted = planted
        ds.bucket = bucket
        ds.packed = pack_problem_from_bits(
            db_bits,
            labels,
            n=n,
            n_pad=bucket.transactions,
            npos_pad=bucket.positives,
            m_pad=bucket.items,
            m_tile=bucket.tile,
            device=resolve_device(device),
        )
        return ds

    @classmethod
    def from_transactions(
        cls,
        transactions,
        labels=None,
        *,
        n_items: int | None = None,
        item_names=None,
        name: str = "transactions",
        bucket_policy: BucketPolicy = DEFAULT_BUCKETS,
        device=None,
    ) -> "Dataset":
        """Prepare a list of transactions, each an iterable of items.

        Items may be integer column ids, or arbitrary string tokens —
        tokens are assigned columns in sorted order and become the item
        names.
        """
        txns = [list(t) for t in transactions]
        has_str = any(isinstance(i, str) for t in txns for i in t)
        if has_str:
            vocab = sorted({str(i) for t in txns for i in t})
            col = {tok: j for j, tok in enumerate(vocab)}
            txns = [[col[str(i)] for i in t] for t in txns]
            if item_names is None:
                item_names = tuple(vocab)
        m = n_items if n_items is not None else (
            1 + max((i for t in txns for i in t), default=-1)
        )
        db = np.zeros((len(txns), max(m, 1)), dtype=bool)
        for r, t in enumerate(txns):
            db[r, t] = True
        return cls(db, labels, item_names=item_names, name=name,
                   bucket_policy=bucket_policy, device=device)

    @classmethod
    def from_tsv(
        cls,
        path: str,
        *,
        name: str | None = None,
        bucket_policy: BucketPolicy = DEFAULT_BUCKETS,
        device=None,
    ) -> "Dataset":
        """Load `<label><TAB>item<TAB>item...` lines (one transaction each);
        the first field is the case/control label (1/0), the rest item
        tokens (strings become item names)."""
        labels, txns = [], []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                fields = line.split("\t")
                labels.append(bool(int(fields[0])))
                txns.append(fields[1:])
        return cls.from_transactions(
            txns, np.asarray(labels, dtype=bool),
            name=name or path, bucket_policy=bucket_policy, device=device,
        )

    @classmethod
    def from_paper_problem(
        cls,
        problem: str,
        scale_items: float = 1.0,
        scale_trans: float = 1.0,
        *,
        seed: int | None = None,
        bucket_policy: BucketPolicy = DEFAULT_BUCKETS,
        device=None,
    ) -> "Dataset":
        """A (scaled) Table-1 synthetic problem, with planted signal and
        SNP-style item names carried along (`.spec` holds its spec)."""
        from repro_torch.data.synthetic import paper_problem

        db, labels, planted, spec = paper_problem(
            problem, scale_items, scale_trans, seed=seed
        )
        names = tuple(f"snp{j:05d}" for j in range(spec.n_items))
        ds = cls(db, labels, item_names=names, name=spec.name,
                 bucket_policy=bucket_policy, planted=planted, device=device)
        ds.spec = spec
        return ds
