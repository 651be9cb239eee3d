"""BSP miner: LCM+LAMP with lifeline work stealing (paper §4), one device.

Counterpart of `repro.core.engine`.  The P logical miners are a leading
tensor dim on one device; each superstep of the host loop in
`build_mine_step` runs the three phase modules:

  1. EXPAND   core/expand.py — pop up to `expand_batch` nodes per miner; one
              popcount-GEMM (the CUDA kernel on the card) gives every
              extension's support; deferred-PPC, closed-set counting, child
              generation.
  2. STEAL    core/steal.py — one lifeline/random exchange round.
  3. GLOBAL   core/global_sync.py — hunger census (the exact termination
              test) and, in mode "lamp1", the periodic lambda sync.

`lax.while_loop` becomes a host loop that reads the census once per
superstep.  Results are bit-identical to the JAX engine at the same P and
lifeline seed: the same histograms, lambda, supersteps, per-miner stats,
emitted records and superstep trace.

With `trace_period > 0` every sampled superstep writes one [N_FIELDS]
record per miner into a [P, trace_cap, N_FIELDS] int32 ring on the device
(repro_torch.obs.trace); the superstep counter is a host int, so unsampled
steps do no trace work at all.

On a card, in one process, with the trace ring off and on the default
stream, each superstep after a program's first is one replay of a CUDA
graph (`_StepGraph`): the ~240 launches of a superstep are captured once,
right after the program's first superstep, and replayed from then on, on
buffers the program owns; the census read stays the loop's one wait on
the device.  The same superstep body runs eagerly elsewhere (the CPU, a
multi-process group, the sampled trace record, a serving fleet's worker
stream) and while `launch.op_cost` counts, which sees only the operators
it dispatches.

Every pass runs through one driver, `run_segments`, and one program: the
driver builds the pass's carry, runs it in segments of `ckpt_period`
supersteps (one segment when it is 0) and reads the outputs of the
terminal carry (`read_outputs`).  Between segments (DESIGN.md §11) it
fires the engine.superstep fault point, hands the carry to a checkpoint
writer and polls a cooperative stop; the carry stays on the device.
`_Carry.to_fields`/`from_fields` map it to and from the JAX package's
host carry dict (`CARRY_FIELDS`), which is the checkpoint format both
packages share; every leaf of the carry is declared once, in
`CARRY_LEAVES`.

Modes:
  lamp1   dynamic lambda by support increase  -> lambda_final
  count   static min_sup                      -> k = CS(min_sup)
  test    static min_sup + delta              -> #significant + pattern records
  count2d static min_sup (+delta=alpha)       -> 2-D (sup x pos-sup) histogram
                                                 + alpha-level pattern records

Topology (DESIGN.md §12): `cfg.topology` (a `repro_torch.topo.Topology`)
swaps the flat lifeline schedule for the hierarchical two-level one over
the same P miners (`make_schedule`).  STEAL reads only the schedule's
global rounds, so a forced H x D shape needs no collectives.  A
`torch.distributed` cluster splits the miner dim over its processes:
`build_mine_step(group=...)` with a `core.collectives.MinerGroup` runs this
process's miners and all-gathers the census, the crossing steal payloads
and the outputs (see `repro_torch.topo.bootstrap`).
"""

from __future__ import annotations

import copy
import threading
import warnings
from dataclasses import dataclass, field, replace
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.support_count import autotune, kernel
from repro_torch.kernels.support_count.ops import resolve_impl, support_counts_tiled
from repro_torch.launch import op_cost
from repro_torch.obs.span import NULL_TRACER
from repro_torch.obs.trace import N_FIELDS, SuperstepTrace, decode_trace
from repro_torch.stats import get_statistic

from .bitmap import (
    DEFAULT_ITEM_TILE,
    BitmapLayout,
    full_occ,
    item_tiling,
    num_words,
    pack_db,
    tensor_to_words,
    words_to_tensor,
)
from .expand import build_expand
from .global_sync import build_global_sync, hunger_census, recompute_lambda
from .lifeline import LifelineSchedule, build_schedule
from .stats import STAT_NAMES, Stat
from .steal import build_steal_round

INT_MAX = np.int32(2**31 - 1)

_NSTAT = len(STAT_NAMES)

#: the engine's pass modes (see module docstring); anything else is a typo
VALID_MODES = ("lamp1", "count", "test", "count2d")


@dataclass(frozen=True)
class EngineConfig:
    """The JAX EngineConfig's fields.  `stack_cap=None` sizes the stack as
    the JAX package's `RuntimeConfig.resolve` does (`resolve_stack_cap`)."""

    expand_batch: int = 16         # B: nodes popped per miner per superstep
    stack_cap: int | None = None   # CAP; None = resolve_stack_cap
    steal_max: int = 256           # T: max nodes per GIVE
    push_cap: int = 1024           # C: max child pushes per superstep
    out_cap: int = 1024            # pattern-record buffer per miner
    max_steps: int = 100_000
    n_random_perms: int = 4
    seed: int = 0
    steal_enabled: bool = True     # False = the paper's "naive approach" (§5.4)
    kernel_impl: str = "auto"      # "auto" | ops.VALID_IMPLS ("ref", "cuda")
    #: the CUDA kernel's (block_b, block_m, block_w) tile for the
    #: superstep's support count; None = autotune.choose_blocks at the
    #: launch's shape (ignored by the plain version)
    kernel_blocks: tuple[int, int, int] | None = None
    #: superstep trace sampling period: 0 = off; k > 0 records one
    #: [N_FIELDS] int32 record per miner every k-th superstep into a
    #: [P, trace_cap, N_FIELDS] device ring (DESIGN.md §9)
    trace_period: int = 0
    trace_cap: int = 0             # ring slots; required > 0 when tracing
    sync_period: int = 4           # supersteps between lambda/histogram syncs
    #: checkpoint cadence (DESIGN.md §11): 0 = the pass runs as one
    #: segment; k > 0 runs it in segments of k supersteps, at whose
    #: boundaries the frontier can be checkpointed and a cooperative stop
    #: polled.  Part of the session's program cache key.
    ckpt_period: int = 0
    #: machine shape (repro_torch.topo): None = the flat schedule; a
    #: Topology selects the hierarchical two-level schedule.  Hashable, so
    #: it lands in the program cache key.
    topology: object | None = None


class _Leaf(NamedTuple):
    """One leaf of the BSP carry: its name, its device form (a key of
    `_FORMS`) and whether a superstep writes it."""

    name: str
    form: str
    step: bool = True


#: the BSP carry's leaves, in carry-tuple order: the JAX package's frontier
#: schema (`repro.core.engine.CARRY_FIELDS`), which is the checkpoint
#: format (ckpt/mining.py).  A leaf is written by a superstep unless it
#: says otherwise; where a CUDA graph replays the superstep, those leaves
#: live at fixed addresses (`_Carry.assign`, `_rebound_back`).  The
#: sampled trace record writes the ring, but never in a replay.
CARRY_LEAVES = (
    _Leaf("occ_stack", "words"),
    _Leaf("meta", "rows"),
    _Leaf("sp", "count"),
    _Leaf("head", "count"),
    _Leaf("hist", "count"),
    _Leaf("hist_snap", "count"),
    _Leaf("g_hist_acc", "shared"),
    _Leaf("hist2d", "count"),
    _Leaf("lam", "scalar"),
    _Leaf("t", "host", step=False),
    _Leaf("stats", "count"),
    _Leaf("out_occ", "words"),
    _Leaf("out_meta", "rows"),
    _Leaf("out_ptr", "count"),
    _Leaf("n_sig", "count"),
    _Leaf("trace", "ring", step=False),
    _Leaf("work", "host", step=False),
)
CARRY_FIELDS = tuple(leaf.name for leaf in CARRY_LEAVES)
STEP_FIELDS = tuple(leaf.name for leaf in CARRY_LEAVES if leaf.step)


def _spill(x: torch.Tensor) -> torch.Tensor:
    """[P, R, C] -> [P, R + 1, C]: a zero spill row appended on the device."""
    return torch.cat([x, x.new_zeros((x.shape[0], 1, x.shape[2]))], dim=1)


def _i32(x: torch.Tensor) -> np.ndarray:
    return x.to(torch.int32).cpu().numpy()


#: a leaf's device form -> (device leaf, P -> host leaf; host leaf, upload,
#: device -> device leaf), the host leaf being the JAX carry's [P, ...]
#: int32 / uint32 array.  `upload(a, dtype)` moves `a` to the device
#: (uint32 words as int32 of the same bits) and counts its bytes.
_FORMS = {
    # [P, R + 1, W] int32 bits with a spill row <-> [P, R, W] uint32 words
    "words": (lambda x, P: tensor_to_words(x[:, :-1]),
              lambda a, up, dev: _spill(up(a, np.uint32))),
    # [P, R + 1, C] int32 with a spill row <-> [P, R, C] int32
    "rows": (lambda x, P: x[:, :-1].cpu().numpy(),
             lambda a, up, dev: _spill(up(a, np.int32))),
    # [P, ...] int64 counters <-> int32, wrapping
    "count": (lambda x, P: _i32(x), lambda a, up, dev: up(a, np.int64)),
    # one int64 row, uniform over the miners <-> [P, ...] int32
    "shared": (lambda x, P: np.tile(_i32(x), (P, 1)),
               lambda a, up, dev: up(a[0], np.int64)),
    # a 0-d int64 tensor, uniform over the miners <-> [P] int32
    "scalar": (lambda x, P: np.full(P, int(x), np.int32),
               lambda a, up, dev: torch.full((), int(a[0]), dtype=torch.int64,
                                             device=dev)),
    # the trace ring [P, slots, N_FIELDS] int32, as it is
    "ring": (lambda x, P: x.cpu().numpy(), lambda a, up, dev: up(a, np.int32)),
    # a host int, uniform over the miners <-> [P] int32
    "host": (lambda x, P: np.full(P, x, np.int32), lambda a, up, dev: int(a[0])),
}
_FORM_OF = {leaf.name: _FORMS[leaf.form] for leaf in CARRY_LEAVES}


def make_schedule(cfg: EngineConfig, n_proc: int) -> LifelineSchedule:
    """The lifeline schedule cfg.topology selects for P = n_proc global
    miners (the schedule half of the JAX `make_mesh_and_schedule`): flat
    without a topology, else the hierarchical two-level one, whose P must
    be n_proc exactly."""
    if cfg.topology is None:
        return build_schedule(n_proc, cfg.n_random_perms, cfg.seed)
    from repro_torch.topo.hierarchy import build_hierarchical_schedule

    if cfg.topology.n_proc != n_proc:
        raise ValueError(
            f"topology {cfg.topology} needs {cfg.topology.n_proc} devices, "
            f"got {n_proc}"
        )
    return build_hierarchical_schedule(cfg.topology, cfg.n_random_perms, cfg.seed)


def resolve_stack_cap(cfg: EngineConfig, m_pad: int, w_pad: int, n_proc: int,
                      stack_mem_mb: int = 256) -> int:
    """cfg.stack_cap, or the JAX `RuntimeConfig.resolve` default: 2 nodes per
    depth-1 root dealt to a miner, floored at 8192, clamped to
    `stack_mem_mb` MiB of stack per miner but never below what one
    superstep can produce."""
    if cfg.stack_cap is not None:
        return int(cfg.stack_cap)
    cap = max(8192, 2 * m_pad // max(n_proc, 1) + 64)
    mem_cap = (stack_mem_mb * 2**20) // (4 * (w_pad + 4))
    floor = 2 * (cfg.push_cap + cfg.steal_max + cfg.expand_batch)
    return int(max(min(cap, mem_cap), floor))


@dataclass
class MineOutput:
    hist: np.ndarray               # [N+2] global closed-set support histogram
    lam_final: int
    supersteps: int
    stats: dict[str, np.ndarray]   # per-miner counters [P]
    sig_count: int = 0             # mode="test"
    sig_sup: np.ndarray | None = None
    sig_pos_sup: np.ndarray | None = None
    trace: SuperstepTrace | None = None  # decoded ring (trace_period > 0)
    hist2d: np.ndarray | None = None  # [N+1, Npos+1] (mode="count2d")
    # emitted pattern records (modes "test"/"count2d"):
    sig_occ: np.ndarray | None = None   # [K, W]u32 occurrence bitmaps
    sig_core: np.ndarray | None = None  # [K] core item of the emitting node
    emit_dropped: int = 0          # records lost to out_cap saturation
    trace_dropped: int = 0         # sampled trace records lost to ring wrap
    db_bits: np.ndarray | None = None  # [M, W]u32 packed DB (reused downstream)
    #: False when the pass stopped cooperatively at a segment boundary
    #: (soft deadline) before draining the frontier — counts/records cover
    #: only the explored region (DESIGN.md §11)
    complete: bool = True


def _thresholds_int(
    n: int, n_pos: int, alpha: float, statistic: str | None = "fisher"
) -> np.ndarray:
    """Integer Tarone support-increase table for the named statistic
    (all INT_MAX for statistic=None: lambda never advances)."""
    if statistic is None:
        return np.full(n + 2, INT_MAX, dtype=np.int32)
    thr = get_statistic(statistic).count_thresholds(n, n_pos, alpha)
    out = np.minimum(np.floor(thr), float(INT_MAX)).astype(np.int64)
    out = out.astype(np.int32)
    out[0] = INT_MAX  # bucket 0 never drives lambda
    out[np.isinf(thr)] = INT_MAX
    return out


@dataclass(frozen=True, eq=False)
class PackedProblem:
    """A transaction database packed once, padded to program dims, with its
    device copy.

    The host numpy arrays are the JAX PackedProblem's (checkpoint
    provenance, the root record); `db_dev` [T, m_tile, W], `pos_mask_dev`
    [W] and `occ0_dev` [W] hold the same bits as int32 on `device`, where
    the root deal and closure reconstruction count them.  `root_supports`
    counts every item's support at the root once per kernel impl and
    keeps it on the host (`_root_sup`).  Padded items/words/positives are
    zero bits, so results do not depend on the padding.
    """

    layout: BitmapLayout   # item-tiled packed DB; layout.m_pad == m_pad
    pos_mask: np.ndarray   # [w_pad] u32 positive-transaction bitmap
    occ0: np.ndarray       # [w_pad] u32 root occurrence (all actual transactions)
    n: int                 # actual transactions
    n_pos: int             # actual positives
    m: int                 # actual items
    n_pad: int             # program transactions
    npos_pad: int          # program positives
    m_pad: int             # program items, tile-aligned
    has_labels: bool
    device: torch.device
    db_dev: torch.Tensor       # [T, m_tile, w_pad] int32 on device
    pos_mask_dev: torch.Tensor  # [w_pad] int32 on device
    occ0_dev: torch.Tensor      # [w_pad] int32 on device
    # impl -> [m_pad] int32 root supports on the host (`root_supports`)
    _root_sup: dict = field(default_factory=dict, init=False, repr=False)

    def __post_init__(self):
        if self.layout.m_pad != self.m_pad:
            raise ValueError(
                f"m_pad={self.m_pad} != layout.m_pad={self.layout.m_pad}"
            )

    @property
    def db_tiles(self) -> np.ndarray:
        return self.layout.tiles

    @property
    def db_bits(self) -> np.ndarray:
        """[m_pad, w_pad] item-major view (host-side)."""
        return self.layout.flat

    @property
    def m_tile(self) -> int:
        return self.layout.m_tile

    @property
    def w_pad(self) -> int:
        return self.layout.w


def packed_from_numpy(
    *, tiles: np.ndarray, m: int, pos_mask: np.ndarray, occ0: np.ndarray,
    n: int, n_pos: int, n_pad: int, npos_pad: int, m_pad: int,
    has_labels: bool, device=None,
) -> PackedProblem:
    """The port's PackedProblem on `device` from plain numpy arrays and ints
    — the fields of the JAX `PackedProblem` — so both packages can mine the
    very same bits."""
    dev = resolve_device(device)
    tiles = np.array(tiles, dtype=np.uint32, copy=True)
    tiles.flags.writeable = False
    layout = BitmapLayout(tiles=tiles, m=int(m))
    pos_mask = np.array(pos_mask, dtype=np.uint32, copy=True)
    occ0 = np.array(occ0, dtype=np.uint32, copy=True)
    for arr in (pos_mask, occ0):
        arr.flags.writeable = False
    return PackedProblem(
        layout=layout, pos_mask=pos_mask, occ0=occ0,
        n=int(n), n_pos=int(n_pos), m=int(m),
        n_pad=int(n_pad), npos_pad=int(npos_pad), m_pad=int(m_pad),
        has_labels=bool(has_labels), device=dev,
        db_dev=words_to_tensor(tiles, dev),
        pos_mask_dev=words_to_tensor(pos_mask, dev),
        occ0_dev=words_to_tensor(occ0, dev),
    )


def pack_problem(
    db_bool: np.ndarray,
    labels: np.ndarray | None = None,
    *,
    n_pad: int | None = None,
    npos_pad: int | None = None,
    m_pad: int | None = None,
    m_tile: int | None = None,
    device=None,
) -> PackedProblem:
    """Pack the bool matrix exactly once, padding to the given program dims
    (default: the exact dataset shape)."""
    db_bool = np.asarray(db_bool, dtype=bool)
    n, m = db_bool.shape
    if labels is not None:
        labels = np.asarray(labels, dtype=bool)
        n_pos = int(labels.sum())
    else:
        n_pos = max(1, n // 2)
    n_pad = n if n_pad is None else n_pad
    npos_pad = n_pos if npos_pad is None else npos_pad
    m_pad = m if m_pad is None else m_pad
    if n_pad < n or npos_pad < n_pos or m_pad < m:
        raise ValueError(
            f"bucket dims ({n_pad}, {npos_pad}, {m_pad}) smaller than dataset "
            f"({n}, {n_pos}, {m})"
        )
    return pack_problem_from_bits(
        pack_db(db_bool), labels, n=n, n_pad=n_pad, npos_pad=npos_pad,
        m_pad=m_pad, m_tile=m_tile, n_pos=n_pos, device=device,
    )


def pack_problem_from_bits(
    db_bits: np.ndarray,
    labels: np.ndarray | None = None,
    *,
    n: int,
    n_pad: int | None = None,
    npos_pad: int | None = None,
    m_pad: int | None = None,
    m_tile: int | None = None,
    n_pos: int | None = None,
    device=None,
) -> PackedProblem:
    """`pack_problem` for an already word-packed [M, W] database (the
    paper-scale entry: no dense [n, m] intermediate)."""
    db_bits = np.asarray(db_bits, dtype=np.uint32)
    m, w = db_bits.shape
    if labels is not None:
        labels = np.asarray(labels, dtype=bool)
        if n_pos is None:
            n_pos = int(labels.sum())
    elif n_pos is None:
        n_pos = max(1, n // 2)
    n_pad = n if n_pad is None else n_pad
    npos_pad = n_pos if npos_pad is None else npos_pad
    m_pad = m if m_pad is None else m_pad
    w_pad = num_words(n_pad)
    if w > w_pad:
        raise ValueError(f"db_bits has {w} words but n_pad={n_pad} fits {w_pad}")
    max_tile = DEFAULT_ITEM_TILE if m_tile is None else m_tile
    m_pad, tile = item_tiling(max(m_pad, 1), max_tile)

    padded = np.zeros((m, w_pad), dtype=np.uint32)
    padded[:, :w] = db_bits
    layout = BitmapLayout.from_db_bits(padded, m=m, m_tile=tile, m_pad=m_pad)
    pos_mask = np.zeros(w_pad, dtype=np.uint32)
    if labels is not None:
        pos_bits = pack_db(labels[:, None])[0]
        pos_mask[: pos_bits.shape[0]] = pos_bits
    occ0 = np.zeros(w_pad, dtype=np.uint32)
    root = full_occ(n)
    occ0[: root.shape[0]] = root
    return packed_from_numpy(
        tiles=layout.tiles, m=m, pos_mask=pos_mask, occ0=occ0,
        n=n, n_pos=n_pos, n_pad=n_pad, npos_pad=npos_pad, m_pad=m_pad,
        has_labels=labels is not None, device=device,
    )


@dataclass(frozen=True, eq=False)
class RootDeal:
    """The depth-1 roots dealt to P miners, compact: one row per dealt
    root, never the [P, CAP, W] stacks, which `_Carry` builds on the
    device from these rows and the resident database.  Root e sits in
    miner e mod P at `slot`, its rank there in ascending item order."""

    meta: np.ndarray        # [R, 4] int32 (e, clo_cum[e], s[e], 0), ascending e
    miner: np.ndarray       # [R] int32
    slot: np.ndarray        # [R] int32
    sp: np.ndarray          # [P] int32 roots per miner
    stack_cap: int
    occ0: torch.Tensor      # [W] int32 root occurrence, on the device

    @property
    def n_proc(self) -> int:
        return self.sp.shape[0]

    @property
    def n_roots(self) -> int:
        return self.meta.shape[0]

    def miners(self, lo: int, hi: int) -> "RootDeal":
        """The roots of miners [lo, hi), renumbered from 0 (a process's
        block of the global miner dim)."""
        keep = (self.miner >= lo) & (self.miner < hi)
        return replace(self, meta=self.meta[keep], miner=self.miner[keep] - lo,
                       slot=self.slot[keep], sp=self.sp[lo:hi])


def root_supports(packed: PackedProblem, impl: str = "auto") -> np.ndarray:
    """[m_pad] int32: every item's support at the root (padded items 0).

    One support count of `occ0_dev` against the resident database
    (`ops.support_counts_tiled` with `impl`, resolved against the
    problem's device: a B = 1 launch of the kernel on the card), read back
    once and kept on the host for every later deal with that impl: the
    root's expansion is the same for every query of a dataset.
    """
    impl = resolve_impl(impl, packed.device)
    s = packed._root_sup.get(impl)
    if s is None:
        s = support_counts_tiled(packed.occ0_dev[None], packed.db_dev,
                                 impl=impl)[0].cpu().numpy()
        s.flags.writeable = False
        packed._root_sup[impl] = s
    return s


def deal_roots(packed: PackedProblem, n_proc: int, stack_cap: int,
               min_sup: int = 1, *, impl: str = "auto") -> RootDeal:
    """Paper §4.5: expand the root, deal depth-1 nodes round-robin (item e
    to miner e mod P, in ascending item order).

    The root's supports are `root_supports(packed, impl)`; the deal is
    host work on the dealt items and the closure items alone.
    """
    s = root_supports(packed, impl)
    # s <= n, so s >= max(1, min_sup) keeps the dealt roots (s < n) and,
    # where any can be dealt, the closure items (s == n) that number them;
    # padded items have s == 0
    items = np.flatnonzero(s >= max(1, min_sup))
    sup = s[items]
    clo = sup == packed.n
    e, sup = items[~clo], sup[~clo]
    miner = e % n_proc
    sp = np.bincount(miner, minlength=n_proc)
    over = np.flatnonzero(sp > stack_cap)
    if over.size:
        raise ValueError(
            f"stack_cap={stack_cap} too small for the depth-1 preprocess "
            f"({sp[over[0]]} roots dealt to miner {over[0]})"
        )
    # slot: the rank among the miner's roots (e ascends, so a stable sort
    # by miner keeps each miner's roots in item order)
    by_miner = np.argsort(miner, kind="stable")
    slot = np.empty_like(e)
    slot[by_miner] = np.arange(e.size) - np.repeat(np.cumsum(sp) - sp, sp)
    clo_cum = np.searchsorted(items[clo], e)   # |clo ∩ [0, e)|
    meta = np.stack([e, clo_cum, sup, np.zeros_like(e)], axis=1)
    i32 = np.int32
    return RootDeal(meta=meta.astype(i32), miner=miner.astype(i32),
                    slot=slot.astype(i32), sp=sp.astype(i32),
                    stack_cap=int(stack_cap), occ0=packed.occ0_dev)


def carry_dims(n: int, n_pos: int, mode: str) -> dict[str, int]:
    """The carry's histogram widths for program dims n / n_pos: `nb`, the
    lamp1 snapshot `snb` and the count2d table `nb2`."""
    nb = n + 2
    return dict(nb=nb, snb=nb if mode == "lamp1" else 1,
                nb2=(n + 1) * (n_pos + 1) if mode == "count2d" else 1)


class _Carry:
    """The BSP carry of all P miners on one device: [P, ...] tensors (the
    stacks and record buffers with a trailing spill row, the counters
    int64), lambda and the replicated lamp1 accumulator `g_hist_acc` held
    once — they are uniform across miners, as in the JAX engine — and the
    superstep counter `t` and the boundary census `work` as host ints: the
    leaves of `CARRY_LEAVES`.  A pass's carry also holds the pass's
    operands, `ops` (the program's `start` sets them)."""

    def __init__(self, *, deal: RootDeal, db_tiles, lam0, nb, snb, nb2,
                 out_cap, trace_cap, device):
        P, R, cap = deal.n_proc, deal.n_roots, deal.stack_cap
        w = db_tiles.shape[-1]
        i64 = torch.int64
        # the stacks (with their spill rows) are zeroed on the device; one
        # upload brings the dealt rows' meta, miner and slot and the counts,
        # and each dealt root's occurrence is gathered from the database
        host = np.concatenate([deal.meta, deal.miner[:, None], deal.slot[:, None]],
                              axis=1)
        up = torch.from_numpy(np.concatenate([host.ravel(), deal.sp])).to(device)
        self.h2d_bytes = up.nbytes
        rows = up[: 6 * R].view(R, 6)
        place = rows[:, 4].long() * (cap + 1) + rows[:, 5]
        self.occ_stack = torch.zeros((P, cap + 1, w), dtype=torch.int32, device=device)
        self.occ_stack.view(-1, w).index_copy_(
            0, place, db_tiles.reshape(-1, w).index_select(0, rows[:, 0]) & deal.occ0)
        self.meta = torch.zeros((P, cap + 1, 4), dtype=torch.int32, device=device)
        self.meta.view(-1, 4).index_copy_(0, place, rows[:, :4])
        self.sp = up[6 * R:].long()
        self.head = torch.zeros(P, dtype=i64, device=device)
        self.hist = torch.zeros((P, nb), dtype=i64, device=device)
        self.hist_snap = torch.zeros((P, snb), dtype=i64, device=device)
        self.g_hist_acc = torch.zeros(snb, dtype=i64, device=device)
        self.hist2d = torch.zeros((P, nb2), dtype=i64, device=device)
        self.lam = torch.full((), int(lam0), dtype=i64, device=device)
        self.t = 0
        self.stats = torch.zeros((P, _NSTAT), dtype=i64, device=device)
        self.out_occ = torch.zeros((P, out_cap + 1, w), dtype=torch.int32, device=device)
        self.out_meta = torch.zeros((P, out_cap + 1, 3), dtype=torch.int32, device=device)
        self.out_ptr = torch.zeros(P, dtype=i64, device=device)
        self.n_sig = torch.zeros(P, dtype=i64, device=device)
        # a 1-slot dummy when tracing is off, as in the JAX carry
        self.trace = torch.zeros((P, max(trace_cap, 1), N_FIELDS), dtype=torch.int32,
                                 device=device)
        # miners with non-empty stacks: the census the loop condition reads
        self.work = int((deal.sp > 0).sum())

    def to_fields(self, names=CARRY_FIELDS) -> dict[str, np.ndarray]:
        """The JAX package's host carry dict (leaves `names`), each leaf as
        its form in `CARRY_LEAVES` maps it: spill rows dropped, counters
        cast to int32 with wraparound, words as uint32, per-miner scalars
        and the replicated leaves as [P] / [P, SNB]."""
        P = self.sp.shape[0]
        return {k: _FORM_OF[k][0](getattr(self, k), P) for k in names}

    def assign(self, other: "_Carry") -> None:
        """Take `other`'s state: the leaves a superstep writes into this
        carry's own buffers, the others and the pass's operands `ops` by
        reference."""
        for leaf in CARRY_LEAVES:
            if leaf.step:
                getattr(self, leaf.name).copy_(getattr(other, leaf.name))
            else:
                setattr(self, leaf.name, getattr(other, leaf.name))
        self.ops = other.ops

    @classmethod
    def from_fields(cls, d: dict, device) -> "_Carry":
        """The inverse of `to_fields`: a carry on `device` from a host carry
        dict (CARRY_FIELDS), written by either package."""
        st = cls.__new__(cls)
        st.h2d_bytes = 0

        def up(a, dtype):   # words (uint32) go up as int32 of the same bits
            a = np.ascontiguousarray(a, dtype)
            t = torch.from_numpy(a.view(np.int32) if dtype == np.uint32 else a)
            st.h2d_bytes += t.nbytes
            return t.to(device)

        for k in CARRY_FIELDS:
            setattr(st, k, _FORM_OF[k][1](d[k], up, device))
        return st


def step_graphs(device: torch.device, group, cfg: EngineConfig) -> bool:
    """Whether a program replays its supersteps as a CUDA graph: on a card,
    in one process (a group's steal and sync call collectives) and with
    the trace ring off (its record is sampled by the host's step count).
    A run replays them only on the default stream (`on_default_stream`)."""
    return device.type == "cuda" and group is None and cfg.trace_period == 0


def on_default_stream(device: torch.device) -> bool:
    """Whether work on `device` goes to its default stream now.  A serving
    fleet's worker runs on a stream of its own in a thread beside others,
    and there a graph replay deadlocks with `torch.profiler` stopped from
    another thread (CUPTI's flush against `cudaGraphLaunch`): its
    supersteps run eagerly."""
    return (device.type != "cuda"
            or torch.cuda.current_stream(device) == torch.cuda.default_stream(device))


def _rebound_back(carry: _Carry, view: _Carry) -> None:
    """Copy the leaves a superstep rebound on `view`, a shallow copy of
    `carry`, into `carry`'s own buffers."""
    for name in STEP_FIELDS:
        new = getattr(view, name)
        if new is not getattr(carry, name):
            getattr(carry, name).copy_(new)


#: held by a capture (`_StepGraph._capture`)
_CAPTURE_LOCK = threading.Lock()


class _StepGraph:
    """A program's superstep as one CUDA graph, replayed step after step.

    A graph replays fixed addresses and frozen scalars, so the superstep
    runs on buffers the program owns: `carry` (the first pass's carry;
    each later pass's is copied into it, and the program hands `carry`
    back), `ops` (the database, positives, thresholds, delta and the
    dataset's N and N_pos as device tensors), the step counter `t` (all
    three loaded once a pass, `t` then advanced by the step) and `census`
    (the hunger census, the graph's one output).
    The step body writes the leaves it rebinds back into `carry`
    (`_rebound_back`); nothing else the graph allocates outlives a replay.

    The program's first superstep runs eagerly on those buffers (it loads
    the kernel and sizes every launch), then the next one is captured,
    which runs nothing; every later superstep replays it, on the default
    stream (`on_default_stream`).  Each replay adds the kernel launches
    the capture recorded to the kernel's counters.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.carry = None
        self.ops = None
        self.t = torch.zeros((), dtype=torch.int64, device=device)
        self.census = torch.zeros((), dtype=torch.int64, device=device)
        self.graph = None
        self.launches = None   # the capture's kernel launches (a replay's)
        #: supersteps run by replay, graphs captured
        self.replays = 0
        self.graphs = 0

    def load(self, st: _Carry) -> _Carry:
        """Take a pass's carry and its operands into the program's buffers,
        at the pass's start; returns the carry the pass goes on with."""
        if self.carry is None:
            self.carry = st
            i64 = torch.int64
            self.ops = tuple(torch.empty_like(x) for x in st.ops[:4]) + tuple(
                torch.empty((), dtype=i64, device=self.device) for _ in range(2))
        else:
            self.carry.assign(st)
        for buf, x in zip(self.ops, st.ops):
            if isinstance(x, torch.Tensor):
                buf.copy_(x)
            else:   # N, N_pos
                buf.fill_(int(x))
        self.t.fill_(st.t)
        return self.carry

    def step(self, body) -> torch.Tensor | None:
        """One superstep: `body(carry)` eagerly and then the capture, the
        first time, else a replay.  Returns the eager step's census, or
        None after a replay (it is in `census`)."""
        if self.graph is not None:
            self.graph.replay()
            kernel.count_replayed(self.launches)
            self.replays += 1
            return None
        view = copy.copy(self.carry)
        n_hungry = body(view)
        _rebound_back(self.carry, view)
        self._capture(body)
        return n_hungry

    def _capture(self, body) -> None:
        # the default stream cannot be captured: a stream of the
        # high-priority pool, which no fleet worker's stream comes from,
        # and one capture at a time, so that two never share a pool stream
        # (a capture on another thread's stream swallows its launches)
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(self.device, priority=-1)
        with _CAPTURE_LOCK, torch.cuda.stream(stream), \
                kernel.recording_launches() as launches:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                view = copy.copy(self.carry)
                self.census.copy_(body(view))
                _rebound_back(self.carry, view)
                del view
            finally:
                graph.capture_end()
        self.graph, self.launches = graph, launches
        self.graphs += 1


def build_mine_step(
    *, n: int, n_pos: int, m: int, cfg: EngineConfig, stack_cap: int,
    schedule: LifelineSchedule, mode: str, device,
    statistic: str | None = "fisher", group=None,
):
    """Wire the superstep phases into the BSP program for P miners.

    `n`/`n_pos`/`m` are the program dims; the dataset's actual counts are
    operands of each pass.  The program `program(carry, t_stop, *,
    tracer)` advances a pass's `_Carry` to superstep t_stop, or until the
    frontier drains, and returns it: in place, or, where the program
    replays CUDA graphs, as the program's own carry, into which the pass's
    first segment copied it.  `program.start(start, packed, ctx)` builds
    the pass's carry, with its operands; `run_segments` drives both.

    Where `step_graphs` holds, the program's supersteps after its first
    are replays of one CUDA graph (`_StepGraph`, the program's
    `step_graph` attribute, whose counters say how many), in the runs
    made on the default stream and outside `op_cost.count_costs`.

    The program takes a keyword `tracer` (`obs.SpanTracer`; default
    `NULL_TRACER`) and records into it one `superstep` span per
    iteration (args `t`, `graph`, true for a replay, and `fired` where
    stealing is on) holding `census.read`, the host's one wait on the
    device a superstep, and, where the superstep runs eagerly, `expand`,
    `steal` and `global`.

    `group` (a `core.collectives.MinerGroup`; unsegmented passes only)
    runs this process's block of the schedule's P miners: the pass then
    starts from that block's dealt roots (`RootDeal.miners`)
    and its outputs are its own rows and sums, which
    `topo.bootstrap.fetch_outputs` gathers.  The loop reads the global
    census, so every process runs the same supersteps.
    """
    if cfg.trace_period < 0:
        raise ValueError(f"trace_period must be >= 0, got {cfg.trace_period}")
    if cfg.trace_period and cfg.trace_cap <= 0:
        raise ValueError(
            "trace_period > 0 requires trace_cap > 0 (the ring needs slots); "
            "RuntimeConfig.resolve() defaults the cap when only the period "
            "is set"
        )
    device = torch.device(device)
    dims = carry_dims(n, n_pos, mode)
    n_proc = schedule.n_proc
    if group is not None and (cfg.ckpt_period > 0 or group.n_miners != n_proc):
        raise ValueError(
            "a multi-process group runs unsegmented passes over the "
            "schedule's P miners"
        )
    n_rows = n_proc if group is None else group.n_local  # carry rows here
    if cfg.kernel_blocks is not None:   # a tile of the superstep's launch
        autotune.check_blocks(cfg.kernel_blocks, n_rows * cfg.expand_batch, m,
                              num_words(n))
    period, tcap = cfg.trace_period, cfg.trace_cap
    kernel_impl = resolve_impl(cfg.kernel_impl, device)
    expand = build_expand(n=n, n_pos=n_pos, m=m, cfg=cfg, stack_cap=stack_cap,
                          mode=mode, kernel_impl=kernel_impl, statistic=statistic)
    steal_round = build_steal_round(schedule, cfg, stack_cap=stack_cap, device=device,
                                    group=group)
    global_sync = build_global_sync(mode=mode, sync_period=cfg.sync_period,
                                    group=group)
    no_steal = torch.zeros(n_rows, dtype=torch.int64, device=device)

    def record(st, t, stats_before, n_hungry, sig_cnt, k_given, k_recv):
        # written *before* global_sync, so LAMBDA is the value in force
        # during this superstep's expand; volumes are this-step stat deltas
        deltas = st.stats - stats_before
        fired = (n_hungry > 0) & bool(cfg.steal_enabled)
        rec = torch.stack([
            torch.full((n_rows,), t, dtype=torch.int64, device=device),  # STEP
            st.lam.expand(n_rows),                    # LAMBDA
            st.sp,                                    # DEPTH
            n_hungry.expand(n_rows),                  # HUNGRY
            fired.long().expand(n_rows),              # FIRED
            deltas[:, Stat.POPPED],                   # POPPED
            deltas[:, Stat.PUSHED],                   # PUSHED
            deltas[:, Stat.CLOSED],                   # CLOSED
            sig_cnt,                                  # EMITTED
            k_given,                                  # DONATED
            k_recv,                                   # RECEIVED
        ], dim=1).to(torch.int32)
        idx = t // period
        st.trace[:, idx % tcap] = rec
        if idx >= tcap:   # the ring wrapped over the oldest record
            st.stats[:, Stat.TRACE_DROPPED] += 1

    def superstep(st, t, ops, span):
        """One superstep's device work on carry `st`: EXPAND, the census,
        STEAL, the counters, the sampled record and GLOBAL.  `t` is the
        host's step count, or on the graph path the device step counter,
        which the step advances.  Returns the census [0-d] and, with a
        group, its host value (read before STEAL)."""
        db_tiles, pos_mask, thr_t, delta_t, n_act, npos_act = ops
        sampled = period > 0 and t % period == 0
        if sampled:
            stats_before = st.stats.clone()
        with span("expand"):
            sig_cnt = expand(st, db_tiles, pos_mask, delta_t, n_act, npos_act)
        st.n_sig += sig_cnt
        # the hunger census: REQUEST side of the steal exchange and the
        # exact termination test (steals only redistribute work)
        hungry_vec = hunger_census(st.sp)
        n_hungry_host = None
        if group is not None:  # every process reads the global census
            (hungry_vec,) = group.all_gather(hungry_vec)
            with span("census.read"):
                n_hungry_host = int(hungry_vec.sum())
        n_hungry = hungry_vec.sum()
        k_given = k_recv = no_steal
        if cfg.steal_enabled:
            with span("steal"):
                got, gave, k_given, k_recv = steal_round(
                    t, hungry_vec, st,
                    any_hungry=group is None or n_hungry_host > 0)
                st.stats[:, Stat.STEALS_GOT] += got
                st.stats[:, Stat.GIVES] += gave
                st.stats[:, Stat.STOLEN_NODES] += k_given
                st.stats[:, Stat.STEAL_ROUNDS] += (n_hungry > 0).long()
        st.stats[:, Stat.IDLE_STEPS] += (st.sp == 0).long()
        st.stats[:, Stat.SUPERSTEPS] += 1
        if sampled:
            record(st, t, stats_before, n_hungry, sig_cnt, k_given, k_recv)
        with span("global"):
            global_sync(t, st, thr_t)
        if isinstance(t, torch.Tensor):
            t.add_(1)
        return n_hungry, n_hungry_host

    step_graph = _StepGraph(device)
    graphs = step_graphs(device, group, cfg)
    no_span = NULL_TRACER.span

    def body(view):   # the superstep a graph captures
        return superstep(view, step_graph.t, step_graph.ops, no_span)[0]

    def program(st, t_stop, *, tracer=NULL_TRACER):
        # `work` (miners with work) is read back once per superstep: the
        # loop's only device -> host sync
        span = tracer.span
        g = (step_graph if graphs and not op_cost.counting()
             and on_default_stream(device) else None)
        if g is not None and st is not g.carry:   # the pass's first segment
            st = g.load(st)
        while st.work > 0 and st.t < t_stop:
            t = st.t
            replay = g is not None and g.graph is not None
            with span("superstep", t=t, graph=replay) as step_args:
                if g is None:
                    n_hungry, n_hungry_host = superstep(st, t, st.ops, span)
                else:
                    n_hungry, n_hungry_host = g.step(body), None
                if n_hungry_host is None:
                    with span("census.read"):
                        n_hungry_host = int(g.census if replay else n_hungry)
                st.work = n_proc - n_hungry_host
                st.t = t + 1
                if step_args is not None and cfg.steal_enabled:
                    step_args["fired"] = n_hungry_host > 0
        return st

    def start(begin, packed: PackedProblem, ctx: dict) -> _Carry:
        """The pass's starting carry on the program's device, from `begin`:
        a `RootDeal` (with a group, this process's block of it) or a
        restored host carry dict.  It holds the pass's operands `ops`:
        the database, positives, thresholds, the gate's delta, N and
        N_pos; `h2d_bytes` counts what it uploaded."""
        if isinstance(begin, dict):
            st = _Carry.from_fields(begin, device)
        else:
            st = _Carry(deal=begin, db_tiles=packed.db_dev, lam0=ctx["start_sup"],
                        **dims, out_cap=cfg.out_cap, trace_cap=tcap, device=device)
            if group is not None:  # the census over every process's miners
                st.work = group.sum_int(st.work)
        delta_t = torch.tensor(ctx["gate"], dtype=torch.float32, device=device)
        thr_t = torch.from_numpy(np.asarray(ctx["thr"], np.int64)).to(device)
        st.ops = (packed.db_dev, packed.pos_mask_dev, thr_t, delta_t, packed.n,
                  packed.n_pos)
        st.h2d_bytes += delta_t.nbytes + thr_t.nbytes
        return st

    program.start = start
    # the program's `_StepGraph`: its replay and capture counts
    program.step_graph = step_graph
    return program


def make_phase_args(
    packed: PackedProblem,
    *,
    n_proc: int,
    cfg: EngineConfig,
    stack_cap: int,
    mode: str,
    alpha: float,
    min_sup: int,
    delta: float,
    statistic: str | None = "fisher",
    tracer=NULL_TRACER,
):
    """A pass's root deal and context.

    Returns (deal, ctx): the `RootDeal` the pass starts from, and ctx =
    dict(thr, start_sup, gate), the thresholds, the pass's starting
    support (its starting lambda) and the device gate's delta in float32,
    which `run_segments` takes and postprocess reads.  The root deal is
    the `roots` span of `tracer` (arg `dealt`, the roots dealt).
    """
    start_sup = min_sup if mode != "lamp1" else 1
    with tracer.span("roots") as roots_args:
        deal = deal_roots(packed, n_proc, stack_cap, start_sup, impl=cfg.kernel_impl)
        if roots_args is not None:
            roots_args["dealt"] = deal.n_roots
    thr = _thresholds_int(packed.n, packed.n_pos, alpha, statistic)
    thr_pad = np.full(packed.n_pad + 2, INT_MAX, dtype=np.int32)
    thr_pad[: thr.shape[0]] = thr
    return deal, dict(thr=thr_pad, start_sup=int(start_sup),
                      gate=float(np.float32(delta)))


class PassOutput(NamedTuple):
    """What a pass returns, read from its terminal carry (`read_outputs`):
    the JAX program's outputs, in their order."""

    hist: np.ndarray           # [NB] int32 histogram summed over the miners
    lam: int
    t: int                     # supersteps
    stats: np.ndarray          # [P, NSTAT] int32 per-miner counters
    out_occ: np.ndarray        # [P, out_cap, W] uint32 emitted occurrences
    out_meta: np.ndarray       # [P, out_cap, 3] int32 (core, sup, pos_sup)
    out_ptr: np.ndarray        # [P] int32 records emitted
    n_sig: int
    trace: np.ndarray | None   # the trace ring; None when tracing is off
    hist2d: np.ndarray         # [NB2] int32 2-D histogram summed over the miners


def read_outputs(st: _Carry, traced: bool) -> PassOutput:
    """A terminal carry's outputs on the host: one exact sum over the
    miners on the device for the histograms and the emitted count, the
    per-miner rows read back (the trace ring only when `traced`)."""
    i32 = np.int32
    return PassOutput(
        st.hist.sum(dim=0).cpu().numpy().astype(i32),
        int(st.lam),
        st.t,
        st.stats.cpu().numpy().astype(i32),
        tensor_to_words(st.out_occ[:, :-1]),
        st.out_meta[:, :-1].cpu().numpy(),
        st.out_ptr.cpu().numpy().astype(i32),
        int(st.n_sig.sum()),
        st.trace.cpu().numpy() if traced else None,
        st.hist2d.sum(dim=0).cpu().numpy().astype(i32),
    )


def run_segments(
    program,
    start,
    packed: PackedProblem,
    ctx: dict,
    *,
    cfg: EngineConfig,
    should_stop=None,
    on_segment=None,
    tracer=NULL_TRACER,
):
    """Run one engine pass of `program` (`build_mine_step`): the one way a
    pass runs.

    `start` is the pass's `RootDeal` or a restored host carry dict
    (CARRY_FIELDS), from which `program.start` builds the carry on the
    device, with `packed`'s and `ctx`'s operands, in the `carry` span of
    `tracer` (arg `bytes`, what it uploaded).  The pass then runs in
    segments of cfg.ckpt_period supersteps; with ckpt_period 0, in one
    segment to cfg.max_steps, and nothing below happens between segments.
    After each segment the engine.superstep fault point fires, then
    `on_segment` gets the device carry (the checkpoint writer, which pulls
    it to the host with `to_fields()`) — in that order, so an injected
    death loses the running segment's checkpoint, the harshest recovery
    case.  `should_stop` is polled after that, and only while the frontier
    is undrained: a cooperative stop always has at least one segment of
    progress behind it.  Between segments the carry stays on the device;
    the loop reads only its host ints `t` and `work`.  The terminal
    carry's outputs are read in the `outputs` span.

    Returns (`PassOutput`, partial).
    """
    from repro_torch.testing import faults

    with tracer.span("carry") as carry_args:
        st = program.start(start, packed, ctx)
        if carry_args is not None:
            carry_args["bytes"] = st.h2d_bytes
    period = cfg.ckpt_period or cfg.max_steps
    partial = False
    while st.work > 0 and st.t < cfg.max_steps:
        st = program(st, min(st.t + period, cfg.max_steps), tracer=tracer)
        if not cfg.ckpt_period:
            break
        faults.check("engine.superstep", t=st.t)
        if on_segment is not None:
            on_segment(st)
        if (
            should_stop is not None
            and st.work > 0
            and st.t < cfg.max_steps
            and should_stop()
        ):
            partial = True
            break
    with tracer.span("outputs"):
        return read_outputs(st, cfg.trace_period > 0), partial


def postprocess_phase(
    raw_out,
    *,
    packed: PackedProblem,
    n_proc: int,
    cfg: EngineConfig,
    mode: str,
    thr: np.ndarray,
    start_sup: int,
    delta: float,
    statistic: str | None = "fisher",
    partial: bool = False,
    schedule: LifelineSchedule | None = None,
) -> MineOutput:
    """Program output -> MineOutput: slice padding, fold in the root closed
    set, gather emitted pattern records, decode the trace ring, surface
    overflow (the JAX `postprocess_phase`, host numpy).  `schedule` (when
    given) keys the decoded trace's per-round steal attribution by the
    round names the pass cycled."""
    n, n_pos = packed.n, packed.n_pos
    root_sup = n  # support of the root closure == all transactions
    (g_hist, lam, t, stats, out_occ, out_meta, out_ptr, g_sig, trace,
     g_hist2d) = raw_out
    g_hist = g_hist.copy()
    if root_sup >= start_sup:
        g_hist[root_sup] += 1
        if mode == "lamp1":
            # replay the lambda recursion including the root contribution
            lam = int(recompute_lambda(g_hist, thr, int(lam)))
    g_hist = g_hist[: n + 2]

    stats_dict = {name: stats[:, i] for i, name in enumerate(STAT_NAMES)}
    if np.any(stats_dict["overflow"]):
        raise RuntimeError("stack overflow in engine: increase stack_cap/push_cap")
    # a cooperative (soft-deadline) stop legitimately leaves the frontier
    # undrained — only an *uninterrupted* pass hitting max_steps is an error
    if not partial and int(t) >= cfg.max_steps:
        raise RuntimeError("engine hit max_steps before termination")

    sig_sup = sig_pos = sig_occ = sig_core = None
    n_sig = int(g_sig)
    emit_dropped = int(stats_dict["emit_dropped"].sum())
    if mode in ("test", "count2d"):
        # gather of the emitted records, miner-major (the JAX order)
        ptrs = out_ptr.reshape(-1)
        live = (np.arange(cfg.out_cap)[None, :] < ptrs[:, None]).reshape(-1)
        sig_occ = out_occ.reshape(n_proc * cfg.out_cap, -1)[live]
        allmeta = out_meta.reshape(n_proc * cfg.out_cap, 3)[live]
        sig_core, sig_sup, sig_pos = allmeta[:, 0], allmeta[:, 1], allmeta[:, 2]
        if emit_dropped:
            warnings.warn(
                f"pattern emission overflow: {emit_dropped} significant records "
                f"dropped (out_cap={cfg.out_cap} saturated); counts stay exact "
                "but the emitted pattern set is incomplete — raise "
                "EngineConfig.out_cap",
                RuntimeWarning,
                stacklevel=3,
            )
    if mode == "test":
        # root significance (host-side, same test as on device)
        if statistic is None:
            if root_sup >= start_sup:
                n_sig += 1
        elif root_sup >= start_sup and packed.has_labels:
            p_root = get_statistic(statistic).pvalue(root_sup, n_pos, n, n_pos)[0]
            if p_root <= delta:
                n_sig += 1

    hist2d = None
    if mode == "count2d":
        hist2d = g_hist2d.reshape(packed.n_pad + 1, packed.npos_pad + 1)
        hist2d = hist2d[: n + 1, : n_pos + 1].copy()
        if root_sup >= start_sup:
            hist2d[root_sup if root_sup <= n else n, n_pos] += 1

    trace_dec = None
    trace_dropped = 0
    if cfg.trace_period:
        trace_dec = decode_trace(
            trace, supersteps=int(t), period=cfg.trace_period,
            round_names=schedule.names if schedule is not None else None,
            round_tiers=schedule.tiers if schedule is not None else None,
        )
        trace_dropped = trace_dec.dropped
        if trace_dropped:
            warnings.warn(
                f"superstep trace ring wrapped: {trace_dropped} oldest "
                f"sampled records overwritten (trace_cap={cfg.trace_cap}, "
                f"trace_period={cfg.trace_period}, {int(t)} supersteps); "
                "the decoded timeline covers only the most recent window — "
                "raise trace_cap or trace_period",
                RuntimeWarning,
                stacklevel=3,
            )
    return MineOutput(
        hist=g_hist,
        lam_final=int(lam),
        supersteps=int(t),
        stats=stats_dict,
        sig_count=n_sig,
        sig_sup=sig_sup,
        sig_pos_sup=sig_pos,
        trace=trace_dec,
        hist2d=hist2d,
        sig_occ=sig_occ,
        sig_core=sig_core,
        emit_dropped=emit_dropped,
        trace_dropped=trace_dropped,
        db_bits=packed.db_bits,
        complete=not partial,
    )


def mine(
    db_bool: np.ndarray | None = None,
    labels: np.ndarray | None = None,
    *,
    mode: str = "lamp1",
    alpha: float = 0.05,
    min_sup: int = 1,
    delta: float = 0.0,
    cfg: EngineConfig = EngineConfig(),
    n_miners: int = 1,
    packed: PackedProblem | None = None,
    statistic: str | None = "fisher",
    device=None,
    ckpt_dir: str | None = None,
    resume_from: str | None = None,
    should_stop=None,
    ckpt_keep: int = 3,
) -> MineOutput:
    """Run one engine pass with `n_miners` virtual miners on one device.

    The one-shot low-level entry: packs the database (unless a prepared
    `packed` is given), runs the BSP program, and postprocesses.  It runs
    where `packed` lives, else on `device` (default: the card; without one
    it raises — pass device="cpu" to run on the CPU).

    With `cfg.ckpt_period > 0` the pass runs in segments (DESIGN.md §11):
    `ckpt_dir` checkpoints the frontier every segment, `resume_from`
    restores the newest valid step (elastically resharded onto
    `n_miners`), and `should_stop()` polled at segment boundaries stops the
    pass cooperatively (MineOutput.complete=False).
    """
    if mode not in VALID_MODES:
        raise ValueError(
            f"unknown engine mode {mode!r}; valid modes: {', '.join(VALID_MODES)}"
        )
    if (ckpt_dir or resume_from or should_stop is not None) and cfg.ckpt_period <= 0:
        raise ValueError(
            "ckpt_dir/resume_from/should_stop need the segmented program: "
            "set EngineConfig.ckpt_period > 0"
        )
    if n_miners < 1:
        raise ValueError(f"n_miners must be >= 1, got {n_miners}")
    if packed is None:
        packed = pack_problem(db_bool, labels, device=resolve_device(device))
    elif device is not None and resolve_device(device) != packed.device:
        raise ValueError(f"packed lives on {packed.device}, not on {device}")
    schedule = make_schedule(cfg, n_miners)
    cfg = replace(cfg, stack_cap=resolve_stack_cap(cfg, packed.m_pad, packed.w_pad,
                                                   n_miners))
    deal, ctx = make_phase_args(
        packed, n_proc=n_miners, cfg=cfg, stack_cap=cfg.stack_cap, mode=mode,
        alpha=alpha, min_sup=min_sup, delta=delta, statistic=statistic,
    )
    program = build_mine_step(
        n=packed.n_pad, n_pos=packed.npos_pad, m=packed.m_pad, cfg=cfg,
        stack_cap=cfg.stack_cap, schedule=schedule, mode=mode,
        device=packed.device, statistic=statistic,
    )
    start, on_segment = deal, None
    if ckpt_dir or resume_from:
        from repro_torch.ckpt import mining as ckpt_mining

        provenance = ckpt_mining.make_provenance(
            packed, mode=mode, statistic=statistic, alpha=alpha,
            start_sup=ctx["start_sup"], delta=delta,
        )
        if resume_from:
            restored = ckpt_mining.restore_frontier(
                resume_from, provenance=provenance, n_proc=n_miners, cfg=cfg,
                mode=mode,
            )
            if restored is not None:
                start = restored
        if ckpt_dir:
            on_segment = ckpt_mining.frontier_writer(
                ckpt_dir, provenance=provenance, keep=ckpt_keep)
    raw, partial = run_segments(program, start, packed, ctx, cfg=cfg,
                                should_stop=should_stop, on_segment=on_segment)
    return postprocess_phase(
        raw, packed=packed, n_proc=n_miners, cfg=cfg, mode=mode,
        thr=ctx["thr"], start_sup=ctx["start_sup"], delta=delta,
        statistic=statistic, partial=partial, schedule=schedule,
    )
