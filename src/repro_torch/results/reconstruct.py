"""Host-side closure reconstruction from emitted pattern records.

Counterpart of `repro.results.reconstruct`.  The closure of a record is the
set of items whose column support under its occurrence bitmap equals the
pattern's support:

    item j  is in  clo(occ)   <=>   |occ & db_bits[j]| == |occ| == sup

evaluated in bulk with the same popcount-GEMM the engine uses — routed
through the port's support-count dispatch, so on the card the CUDA kernel
is its second caller.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitmap import words_to_tensor
from repro_torch.device import resolve_device
from repro_torch.obs.span import NULL_TRACER

__all__ = ["reconstruct_closures", "dedup_by_closure"]


def reconstruct_closures(
    occ: np.ndarray, sup: np.ndarray, db_bits, chunk: int = 512,
    device=None, impl: str = "auto", tracer=NULL_TRACER,
) -> list[tuple[int, ...]]:
    """[K, W] occurrence bitmaps + [K] supports -> K closure itemsets.

    `db_bits` is the [M, W] database: uint32 numpy words, uploaded to
    `device` (default: the card), or an int32 tensor, used where it lies.
    Records are counted against it `chunk` at a time, so the [chunk, M]
    output stays small.  `impl` is the support count's (`ops.resolve_impl`:
    "auto" takes the kernel on the card).  Each chunk records three spans
    into `tracer`: `closure.count` (the count and the compare, queued on
    the device), `closure.readback` (the [chunk, M] mask to the host,
    waiting for the count; args `bytes`) and `closure.scan` (the host's
    scan of the mask).
    """
    from repro_torch.kernels.support_count.ops import support_counts

    if isinstance(db_bits, torch.Tensor):
        db, dev = db_bits, db_bits.device
    else:
        dev = resolve_device(device)
        db = None
    occ = np.asarray(occ, dtype=np.uint32)
    sup = np.asarray(sup)
    k = occ.shape[0]
    out: list[tuple[int, ...]] = []
    if k == 0:
        return out
    if db is None:
        db = words_to_tensor(np.asarray(db_bits), dev)
    for lo in range(0, k, chunk):
        hi = min(lo + chunk, k)
        with tracer.span("closure.count"):
            # blocks=None: the kernel's tile is chosen at each chunk's own shape
            s = support_counts(words_to_tensor(occ[lo:hi], dev), db,
                               impl=impl)  # [chunk, M]
            want = torch.from_numpy(sup[lo:hi].astype(np.int64)).to(dev)
            mask = s == want[:, None]
        with tracer.span("closure.readback", bytes=mask.numel()):
            in_clo = mask.cpu().numpy()
        with tracer.span("closure.scan"):
            for r in range(hi - lo):
                out.append(tuple(np.flatnonzero(in_clo[r]).tolist()))
    return out


def dedup_by_closure(closures, *fields):
    """Keep the first record of every distinct closure (order preserved).

    closures: list of item tuples; fields: parallel arrays/lists to subset.
    """
    seen: set[tuple[int, ...]] = set()
    keep: list[int] = []
    for i, c in enumerate(closures):
        if c not in seen:
            seen.add(c)
            keep.append(i)
    kept_closures = [closures[i] for i in keep]
    kept_fields = tuple(np.asarray(f)[keep] for f in fields)
    return (kept_closures, *kept_fields)
