"""The support-count CUDA kernel's tile: candidates, a model, a seed table
(counterpart of `repro.kernels.support_count.autotune`).

A tile is a `(block_b, block_m, block_w)` triple in the kernel's own units
(`csrc/support_count.cu`):

  block_b  occ rows per block, 16 per warp: 16, 32, 64 or 128
  block_m  items per database ring tile: 32, 64 or 128
  block_w  words of K staged per unit, 32 or 64: while W <= block_w the
           block's occ rows stay resident (K = W rounded up to 8 words),
           above it both operands are staged in chunks of block_w words

`block_m` and `block_w` are template parameters of the kernel (six
instantiations), the warp count a runtime value.  `candidate_blocks` lists
the instantiated tiles that fit a shape and the 227 KiB of shared memory a
block may use.

`choose_blocks` picks one for an exact (B, M, W), in two layers:

  1. the seed table: rows measured on a card (`measure_blocks`, written by
     `save_seed_table`); a measured row for this shape, impl and card name
     wins.  `load_seed_table` reads one, and so does the first choice in a
     process when REPRO_TORCH_SC_AUTOTUNE names a file (a bad file is
     ignored, as the JAX package ignores one);
  2. without one, the rule the kernel's C launcher applied before the tile
     became a parameter: 64 items, occ resident up to 64 words (else
     chunks of 32), and the most rows per block (at most 128) whose row
     blocks times item tiles still give every SM two blocks, halving down
     to 16.

`modeled_time_us` is an analytic H100 model of one launch: the bytes (the
database read once per row block) over 3.35 TB/s against the bit
operations of the padded tile over the int8 tensor rate, divided by a
parallel efficiency (row blocks x item tiles against two blocks per SM).
It does not reproduce the launcher's rule at any shape of PERF.md's kernel
table: it always takes 32-item tiles and more rows per block, e.g.
(32, 32, 32) at (128, 2048, 32) where the launcher took (16, 64, 32),
because it charges every row block's read of the database at the DRAM
rate (at 2,048 items the re-reads hit L2) and charges nothing per tile
(the epilogue, the ring's barriers).  So the launcher's rule stays the
default at every shape, and a different default is a performance change
for a measured PR; the model orders `measure_blocks`' candidates and is
reported beside each measured time.

Unlike the JAX package, shapes are not bucketed to powers of two: a Pallas
block must divide the padded array, so JAX pads each dim to a bucket and
keys the choice on it, while the CUDA kernel masks its ragged edges and
launches at the exact shape, so the choice is keyed on (B, M, W) itself.
"""

from __future__ import annotations

import functools
import json
import os
import threading

__all__ = [
    "SMEM_BUDGET",
    "TILE_ITEMS",
    "TILE_ROWS",
    "TILE_WORDS",
    "candidate_blocks",
    "card_info",
    "check_blocks",
    "choose_blocks",
    "clear_seed_table",
    "launcher_blocks",
    "load_seed_table",
    "measure_blocks",
    "modeled_time_us",
    "save_seed_table",
    "smem_bytes",
]

#: the instantiated tile dims (csrc/support_count.cu::sc_support_count)
TILE_ROWS = (16, 32, 64, 128)
TILE_ITEMS = (32, 64, 128)
TILE_WORDS = (32, 64)
#: dynamic shared memory a block may use on Hopper (227 KiB)
SMEM_BUDGET = 232_448
#: shared memory of one SM that blocks share (228 KiB), and what the
#: runtime reserves per block
_SMEM_PER_SM = 233_472
_SMEM_RESERVED = 1024
_STAGES = 3            # the database ring's depth (kStages)
_BLOCKS_PER_SM = 2     # __launch_bounds__(256, 2)

#: H100 SXM peaks (NVIDIA's data sheet, dense; chip_smoke.py's bound)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
H100_SMS = 132

_ENV_SEED = "REPRO_TORCH_SC_AUTOTUNE"

_seed_rows: list[dict] = []
_seed_gen = 0          # bumped on load/clear so the lru cache serves no stale pick
_env_loaded = False
_seed_lock = threading.Lock()


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def smem_bytes(blocks: tuple[int, int, int], w: int) -> int:
    """Dynamic shared memory of one block (the kernel's `Plan`, transcribed)."""
    rows, items, block_w = blocks
    flat = w <= block_w
    kw = _round_up(w, 8) if flat else block_w
    occ_words = rows * (kw + 4)
    if flat:
        stage_words = _round_up(items * w + 8, 4)
    else:
        stage_words = occ_words + items * (block_w + 4)
    out_words = rows * (items + 8)
    return 4 * ((occ_words if flat else 0) + _STAGES * stage_words + out_words)


@functools.lru_cache(maxsize=1024)
def candidate_blocks(b: int, m: int, w: int) -> tuple[tuple[int, int, int], ...]:
    """The instantiated tiles that fit (B, M, W): no more rows than B
    rounded up to 16, no more items than M rounded up to 32, block_w = 64
    only where W > 32 (below, both block_w run the same resident plan),
    and shared memory within `SMEM_BUDGET`."""
    out = []
    for rows in TILE_ROWS:
        if rows > max(16, _round_up(b, 16)):
            continue
        for items in TILE_ITEMS:
            if items > max(32, _round_up(m, 32)):
                continue
            for block_w in TILE_WORDS:
                if block_w > max(32, _round_up(w, 32)):
                    continue
                if smem_bytes((rows, items, block_w), w) <= SMEM_BUDGET:
                    out.append((rows, items, block_w))
    return tuple(out)


def launcher_blocks(b: int, m: int, w: int, sms: int = H100_SMS) -> tuple[int, int, int]:
    """The tile the kernel's C launcher chose before the tile became a
    parameter: 64 items; resident occ up to 64 words, else chunks of 32;
    the most rows (a power of two, at most 128) whose row blocks times
    item tiles give every SM two blocks, else 16."""
    ntiles = -(-m // 64)
    rows = 128
    while rows > 16 and rows // 2 >= _round_up(b, 16):
        rows //= 2
    while rows > 16 and -(-b // rows) * ntiles < _BLOCKS_PER_SM * sms:
        rows //= 2
    return rows, 64, 64 if 32 < w <= 64 else 32


def modeled_time_us(b: int, m: int, w: int, blocks: tuple[int, int, int],
                    sms: int = H100_SMS) -> float:
    """Analytic H100 time of one launch at this tile (see the module doc)."""
    rows, items, _ = blocks
    row_blocks = -(-b // rows)
    ntiles = -(-m // items)
    moved = (row_blocks * m * w + b * w + b * m) * 4
    bit_ops = 2 * (row_blocks * rows) * (ntiles * items) * 32 * _round_up(w, 8)
    per_sm = min(_BLOCKS_PER_SM,
                 _SMEM_PER_SM // (smem_bytes(blocks, w) + _SMEM_RESERVED))
    eff = min(1.0, row_blocks * ntiles / (max(per_sm, 1) * sms))
    return max(moved / HBM_BYTES_PER_S, bit_ops / INT8_OPS_PER_S) / eff * 1e6


@functools.lru_cache(maxsize=16)
def _card_info(index: int) -> tuple[str, int]:
    import torch

    return (torch.cuda.get_device_name(index),
            torch.cuda.get_device_properties(index).multi_processor_count)


def card_info(device=None) -> tuple[str, int]:
    """(name, SM count) of a CUDA device (default: the current one)."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    return _card_info(dev.index if dev.index is not None else torch.cuda.current_device())


def _seed_lookup(b: int, m: int, w: int, impl: str, card: str):
    best = None
    for row in _seed_rows:
        if (row.get("impl") != impl or row.get("device") != card
                or list(row.get("shape", ())) != [b, m, w]):
            continue
        if tuple(row["blocks"]) not in candidate_blocks(b, m, w):
            continue
        if best is None or row["time_us"] < best["time_us"]:
            best = row
    return tuple(best["blocks"]) if best else None


@functools.lru_cache(maxsize=512)
def _choose(b: int, m: int, w: int, impl: str, card: str, sms: int, gen: int):
    seeded = _seed_lookup(b, m, w, impl, card)
    return seeded if seeded is not None else launcher_blocks(b, m, w, sms)


def choose_blocks(b: int, m: int, w: int, impl: str = "cuda", *,
                  card: str | None = None,
                  sms: int | None = None) -> tuple[int, int, int] | None:
    """The (block_b, block_m, block_w) tile for an exact [B, W] x [M, W]
    count on the card named `card` with `sms` SMs (default: the current
    CUDA device's).  None for impl "ref": the plain version has no tile.

    Deterministic per (shape, impl, card, SM count, loaded seed table).
    """
    if impl == "ref":
        return None
    if impl != "cuda":
        raise ValueError(f"unknown kernel impl {impl!r}; valid: ref, cuda")
    _maybe_load_env()
    if card is None or sms is None:
        name, count = card_info()
        card = name if card is None else card
        sms = count if sms is None else sms
    return _choose(int(b), int(m), int(w), impl, card, int(sms), _seed_gen)


def check_blocks(blocks, b: int, m: int, w: int) -> tuple[int, int, int]:
    """`blocks` as a tuple if it is a candidate tile of (B, M, W), else a
    ValueError that names `kernel_blocks` and lists the candidates."""
    cands = candidate_blocks(int(b), int(m), int(w))
    try:
        tile = tuple(int(x) for x in blocks)
    except (TypeError, ValueError):
        tile = None
    if tile not in cands:
        raise ValueError(
            f"kernel_blocks {blocks!r} is not a tile of the CUDA kernel at "
            f"(B, M, W) = {(b, m, w)}; valid (block_b, block_m, block_w): "
            f"{', '.join(str(c) for c in cands)}"
        )
    return tile


# ------------------------------------------------------------- seed table IO
def _bump() -> None:
    global _seed_gen
    _seed_gen += 1
    _choose.cache_clear()


def load_seed_table(path: str) -> int:
    """Add the rows of a seed table ({impl, device, shape, blocks, time_us,
    modeled_us}); returns the number of rows loaded in all."""
    with open(path) as f:
        rows = json.load(f)
    rows = rows["rows"] if isinstance(rows, dict) else rows
    with _seed_lock:
        _seed_rows.extend(rows)
        _bump()
        return len(_seed_rows)


def clear_seed_table() -> None:
    with _seed_lock:
        _seed_rows.clear()
        _bump()


def save_seed_table(path: str, rows: list[dict]) -> str:
    with open(path, "w") as f:
        json.dump({"suite": "support-count-autotune", "rows": rows}, f, indent=1)
        f.write("\n")
    return path


def _maybe_load_env() -> None:
    global _env_loaded
    if _env_loaded:
        return
    with _seed_lock:
        if _env_loaded:
            return
        _env_loaded = True
    path = os.environ.get(_ENV_SEED)
    if path and os.path.exists(path):
        try:
            load_seed_table(path)
        except (OSError, ValueError, KeyError, TypeError):
            pass  # a bad seed file must never break kernel dispatch


# ------------------------------------------------------------------ measure
def measure_blocks(b: int, m: int, w: int, *, iters: int = 50, seed: int = 0,
                   device_time: bool = False) -> list[dict]:
    """Time every candidate tile of (B, M, W) on the current CUDA device;
    seed-table rows sorted fastest first.

    `time_us` is the CUDA-event time per call over `iters` back-to-back
    calls, enqueued while the stream sleeps (for about 0.2 ms a call), so
    that the host's launch rate does not set the pace.  With
    `device_time`, `device_us` is the profiler's device time of the kernel
    per call, and the rows are sorted by it.  Launches here count in
    `kernel.launches` like any other.
    """
    import torch

    from . import kernel

    dev = torch.device("cuda", torch.cuda.current_device())
    card, sms = card_info(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    occ = torch.randint(-2**31, 2**31, (b, w), dtype=torch.int32, device=dev,
                        generator=gen)
    db = torch.randint(-2**31, 2**31, (m, w), dtype=torch.int32, device=dev,
                       generator=gen)
    cands = sorted(candidate_blocks(int(b), int(m), int(w)),
                   key=lambda blk: modeled_time_us(b, m, w, blk, sms))
    rows = []
    for blk in cands:
        def call(blk=blk):
            return kernel.support_count_cuda(occ, db, blocks=blk)

        call()
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(iters * 400_000)  # the launches queue behind it
        start.record()
        for _ in range(iters):
            call()
        end.record()
        torch.cuda.synchronize(dev)
        row = {"impl": "cuda", "device": card, "shape": [b, m, w],
               "blocks": list(blk),
               "time_us": start.elapsed_time(end) * 1e3 / iters,
               "modeled_us": modeled_time_us(b, m, w, blk, sms),
               "smem_kib": smem_bytes(blk, w) / 1024}
        if device_time:
            row["device_us"] = _device_us(call, iters)
        rows.append(row)
    key = "device_us" if device_time else "time_us"
    rows.sort(key=lambda r: (r[key] is None, r[key] or 0.0))
    return rows


def _device_us(call, iters: int) -> float | None:
    """The profiler's device time of the kernel per call over `iters`
    calls; None when it saw another number of launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    n, us = 0, 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "support_count_kernel" in e.key:
            n += e.count
            us += getattr(e, "self_device_time_total", None) or 0.0
    return us / iters if n == iters else None
