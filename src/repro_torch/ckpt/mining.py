"""Mining-frontier checkpoints: BSP carry ⇄ `ckpt.checkpoint` steps
(counterpart of `repro.ckpt.mining`, the same format: a frontier written by
either package resumes in the other).

The BSP carry *is* the search frontier (deque stacks + head/sp pointers,
lamp1 histogram + sync state, lambda, stats, emitted records) — task-
parallel FPM's free fault tolerance, DESIGN.md §11.  This module maps the
host-side carry dict (`engine.CARRY_FIELDS`) onto the generic step format
of `repro_torch.ckpt.checkpoint` and adds the two things a *mining* checkpoint
needs on top:

provenance
    The manifest carries the dataset fingerprint (sha256 of the packed
    bitmap + label mask + dims) and the query-determining knobs (mode,
    statistic, alpha, start_sup, delta).  A resume against a checkpoint
    whose provenance does not match raises `ProvenanceMismatch` loudly —
    it never silently falls back to an older step, because *every* step
    in that directory is equally wrong for this query.

elastic resharding
    A frontier saved at P miners restores onto P′ devices: each miner's
    deque is linearized in logical order, the concatenated node list is
    re-dealt round-robin, additive state (histograms, n_sig, counter
    stats) merges onto miner 0, replicated state (lambda, t, lamp1 sync
    accumulators) is broadcast, and emitted records re-split contiguously.
    Correctness does not depend on the re-deal order — steals migrate
    self-contained node payloads during the run, and the final lambda is
    replayed exactly from the global histogram in postprocess — which is
    why the resumed mine's ResultSet is bit-identical for P→P′.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np

from repro_torch.core.engine import CARRY_FIELDS, EngineConfig
from repro_torch.core.stats import Stat
from repro_torch.obs.trace import N_FIELDS

from . import checkpoint

__all__ = [
    "FORMAT",
    "ProvenanceMismatch",
    "dataset_fingerprint",
    "frontier_writer",
    "make_provenance",
    "reshard_frontier",
    "restore_frontier",
    "save_frontier",
    "verify_provenance",
]

FORMAT = "mining-frontier-v1"

#: provenance keys that must match exactly for a resume to be legal
_MATCH_KEYS = (
    "format", "fingerprint", "mode", "statistic", "alpha", "start_sup",
    "delta",
)

#: stats columns that are per-superstep (identical on every miner), not
#: additive — on reshard they are broadcast from old miner 0, not summed
_REPLICATED_STATS = (Stat.SUPERSTEPS, Stat.STEAL_ROUNDS)


class ProvenanceMismatch(ValueError):
    """Checkpoint was written by a different dataset/query — resume refused."""


def dataset_fingerprint(packed) -> str:
    """sha256 over the packed database bytes, label mask, and actual dims."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(packed.db_bits).tobytes())
    h.update(np.ascontiguousarray(packed.pos_mask).tobytes())
    h.update(repr((packed.n, packed.n_pos, packed.m,
                   packed.n_pad, packed.npos_pad, packed.m_pad)).encode())
    return h.hexdigest()


def make_provenance(
    packed, *, mode: str, statistic: str | None, alpha: float,
    start_sup: int, delta: float,
) -> dict:
    """The identity a frontier checkpoint must match to be resumable."""
    return {
        "format": FORMAT,
        "fingerprint": dataset_fingerprint(packed),
        "mode": mode,
        "statistic": statistic,
        "alpha": float(alpha),
        "start_sup": int(start_sup),
        "delta": float(delta),
    }


def verify_provenance(meta: dict, provenance: dict) -> None:
    """Raise ProvenanceMismatch naming every key that disagrees."""
    bad = [
        f"{k}: checkpoint={meta.get(k)!r} != current={provenance.get(k)!r}"
        for k in _MATCH_KEYS
        if meta.get(k) != provenance.get(k)
    ]
    if bad:
        raise ProvenanceMismatch(
            "checkpoint provenance does not match this mine (refusing to "
            "resume): " + "; ".join(bad)
        )


def save_frontier(
    carry: dict[str, np.ndarray], directory: str, *, provenance: dict,
    keep: int = 3,
):
    """Write one frontier step (step number = the carry's superstep count).

    Returns (published path, payload bytes).
    """
    step = int(carry["t"][0])
    meta = dict(provenance, n_miners=int(carry["sp"].shape[0]))
    path = checkpoint.save(carry, directory, step, meta=meta, keep=keep)
    nbytes = int(sum(np.asarray(v).nbytes for v in carry.values()))
    return path, nbytes


def frontier_writer(directory: str, *, provenance: dict, keep: int = 3,
                    written=None):
    """A pass's `on_segment` hook (`engine.run_segments`): each segment's
    device carry saved as a frontier step of `directory`.  `written(path,
    nbytes, seconds)`, where given, hears of every write."""
    def on_segment(carry):
        t0 = time.perf_counter()
        path, nbytes = save_frontier(carry.to_fields(), directory,
                                     provenance=provenance, keep=keep)
        if written is not None:
            written(path, nbytes, time.perf_counter() - t0)

    return on_segment


def load_frontier(directory: str, step: int):
    """Raw read of one frontier step -> (carry dict, manifest).

    Raises CorruptCheckpoint on damage, including a missing carry leaf.
    """
    data, manifest = checkpoint.load_step(directory, step)
    missing = [k for k in CARRY_FIELDS if k not in data]
    if missing:
        raise checkpoint.CorruptCheckpoint(
            f"step {step}: frontier leaves missing: {missing}"
        )
    return {k: data[k] for k in CARRY_FIELDS}, manifest


def restore_frontier(
    directory: str,
    *,
    provenance: dict,
    n_proc: int,
    cfg: EngineConfig,
    mode: str,
    step: int | None = None,
):
    """Newest valid frontier step, elastically resharded onto n_proc miners.

    Corrupt steps fall back newest→oldest (via `checkpoint.restore_latest`
    semantics); a provenance mismatch raises immediately — older steps in
    the same directory were written by the same mine and are equally
    mismatched.  Returns None when the directory holds no steps at all.
    """
    import warnings

    steps = checkpoint.list_steps(directory)
    if step is not None:
        steps = [s for s in steps if s == step]
        if not steps:
            raise checkpoint.CheckpointError(
                f"no step {step} in {directory} (have {checkpoint.list_steps(directory)})"
            )
    if not steps:
        return None
    for s in reversed(steps):
        try:
            carry, manifest = load_frontier(directory, s)
        except checkpoint.CorruptCheckpoint as e:
            warnings.warn(
                f"skipping corrupt frontier step {s} in {directory}: {e}",
                RuntimeWarning, stacklevel=2)
            continue
        verify_provenance(manifest.get("meta", {}), provenance)
        return reshard_frontier(carry, n_proc=n_proc, cfg=cfg, mode=mode)
    return None


def reshard_frontier(
    carry: dict[str, np.ndarray], *, n_proc: int, cfg: EngineConfig,
    mode: str,
) -> dict[str, np.ndarray]:
    """Repartition a P-miner frontier onto n_proc miners (the re-deal).

    Same miner count *and* same buffer capacities passes the carry through
    untouched (bit-identical resume at fixed topology).  Otherwise:

    - stacks: each deque linearized bottom→top from its ring
      (`(head+i) % cap`), concatenated miner-major, node j dealt to new
      miner j % P′; new heads are 0.
    - additive state (hist/hist2d/n_sig/counter stats): totals onto new
      miner 0, zeros elsewhere — global sums (all the engine ever reads)
      are preserved exactly.
    - replicated state (lambda, t, superstep-counting stats): broadcast
      from old miner 0.
    - lamp1 sync state: by the sync invariant g_hist_acc == Σ_p
      hist_snap[p], setting hist_snap[0] = Σ hist and g_hist_acc = Σ hist
      on every miner re-establishes a consistent just-synced state.
    - emitted records: re-split contiguously across the new out buffers.
    - trace ring: per-miner diagnostic, not portable — zeroed.

    Raises ValueError when a new miner's share exceeds stack_cap/out_cap.
    `cfg` is resolved: its stack_cap is the int the resuming run uses.
    """
    old_p = int(carry["sp"].shape[0])
    cap_old = int(carry["occ_stack"].shape[1])
    out_cap_old = int(carry["out_occ"].shape[1])
    trace_shape = (max(cfg.trace_cap, 1), N_FIELDS)
    if (
        old_p == n_proc
        and cap_old == cfg.stack_cap
        and out_cap_old == cfg.out_cap
        and tuple(carry["trace"].shape[1:]) == trace_shape
    ):
        return {k: np.ascontiguousarray(v) for k, v in carry.items()}

    i32 = np.int32
    w = carry["occ_stack"].shape[2]
    sp = np.asarray(carry["sp"], i32)
    head = np.asarray(carry["head"], i32)

    # --- stacks: linearize every deque in logical order, re-deal round-robin
    occ_rows, meta_rows = [], []
    for p in range(old_p):
        idx = (int(head[p]) + np.arange(int(sp[p]))) % cap_old
        occ_rows.append(carry["occ_stack"][p, idx])
        meta_rows.append(carry["meta"][p, idx])
    occ_all = (np.concatenate(occ_rows) if occ_rows
               else np.zeros((0, w), np.uint32))
    meta_all = (np.concatenate(meta_rows) if meta_rows
                else np.zeros((0, carry["meta"].shape[2]), i32))
    total = occ_all.shape[0]

    new_occ = np.zeros((n_proc, cfg.stack_cap, w), np.uint32)
    new_meta = np.zeros((n_proc, cfg.stack_cap, carry["meta"].shape[2]), i32)
    new_sp = np.zeros(n_proc, i32)
    for p in range(n_proc):
        sel = np.arange(p, total, n_proc)
        k = sel.size
        if k > cfg.stack_cap:
            raise ValueError(
                f"elastic reshard: miner {p} would receive {k} frontier "
                f"nodes > stack_cap={cfg.stack_cap}; raise stack_cap or "
                "restore onto more devices"
            )
        new_occ[p, :k] = occ_all[sel]
        new_meta[p, :k] = meta_all[sel]
        new_sp[p] = k

    # --- additive state: totals on miner 0 preserve every global sum
    def totals_on_zero(arr):
        out = np.zeros((n_proc,) + arr.shape[1:], arr.dtype)
        out[0] = arr.sum(axis=0, dtype=arr.dtype)
        return out

    new_hist = totals_on_zero(np.asarray(carry["hist"], i32))
    new_hist2d = totals_on_zero(np.asarray(carry["hist2d"], i32))
    new_n_sig = totals_on_zero(np.asarray(carry["n_sig"], i32))

    new_stats = totals_on_zero(np.asarray(carry["stats"], i32))
    for col in _REPLICATED_STATS:
        new_stats[:, col] = carry["stats"][0, col]

    # --- lamp1 sync state (dummies of width 1 in other modes merge the same
    # way: sums of zeros stay zero)
    snb = carry["hist_snap"].shape[1]
    hist_tot = np.asarray(carry["hist"], i32).sum(axis=0, dtype=i32)
    new_snap = np.zeros((n_proc, snb), i32)
    new_acc = np.zeros((n_proc, snb), i32)
    if mode == "lamp1":
        new_snap[0] = hist_tot[:snb]
        new_acc[:] = hist_tot[:snb]

    # --- emitted records: contiguous re-split
    out_ptr = np.asarray(carry["out_ptr"], i32)
    live = (np.arange(out_cap_old)[None, :] < out_ptr[:, None]).reshape(-1)
    rec_occ = carry["out_occ"].reshape(old_p * out_cap_old, -1)[live]
    rec_meta = carry["out_meta"].reshape(old_p * out_cap_old, -1)[live]
    k_out = rec_occ.shape[0]
    base, extra = divmod(k_out, n_proc)
    if base + (1 if extra else 0) > cfg.out_cap:
        raise ValueError(
            f"elastic reshard: {k_out} emitted records do not fit "
            f"{n_proc} x out_cap={cfg.out_cap}; raise out_cap"
        )
    new_out_occ = np.zeros((n_proc, cfg.out_cap, w), np.uint32)
    new_out_meta = np.zeros(
        (n_proc, cfg.out_cap, carry["out_meta"].shape[2]), i32)
    new_out_ptr = np.zeros(n_proc, i32)
    off = 0
    for p in range(n_proc):
        k = base + (1 if p < extra else 0)
        new_out_occ[p, :k] = rec_occ[off:off + k]
        new_out_meta[p, :k] = rec_meta[off:off + k]
        new_out_ptr[p] = k
        off += k

    return {
        "occ_stack": new_occ,
        "meta": new_meta,
        "sp": new_sp,
        "head": np.zeros(n_proc, i32),
        "hist": new_hist,
        "hist_snap": new_snap,
        "g_hist_acc": new_acc,
        "hist2d": new_hist2d,
        "lam": np.full(n_proc, int(carry["lam"][0]), i32),
        "t": np.full(n_proc, int(carry["t"][0]), i32),
        "stats": new_stats,
        "out_occ": new_out_occ,
        "out_meta": new_out_meta,
        "out_ptr": new_out_ptr,
        "n_sig": new_n_sig,
        "trace": np.zeros((n_proc,) + trace_shape, i32),
        "work": np.full(n_proc, int((new_sp > 0).sum()), i32),
    }
