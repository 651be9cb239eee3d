"""BSP miner: LCM+LAMP with lifeline work stealing (paper §4), one device.

Counterpart of `repro.core.engine` (its classic, unsegmented path).  The P
logical miners are a leading tensor dim on one device; each superstep of
the host loop in `build_mine_step` runs the three phase modules:

  1. EXPAND   core/expand.py — pop up to `expand_batch` nodes per miner; one
              popcount-GEMM (the CUDA kernel on the card) gives every
              extension's support; deferred-PPC, closed-set counting, child
              generation.
  2. STEAL    core/steal.py — one lifeline/random exchange round.
  3. GLOBAL   core/global_sync.py — hunger census (the exact termination
              test) and, in mode "lamp1", the periodic lambda sync.

`lax.while_loop` becomes a host loop that reads the census once per
superstep.  Results are bit-identical to the JAX engine at the same P and
lifeline seed: the same histograms, lambda, supersteps, per-miner stats and
emitted records.

Modes:
  lamp1   dynamic lambda by support increase  -> lambda_final
  count   static min_sup                      -> k = CS(min_sup)
  test    static min_sup + delta              -> #significant + pattern records
  count2d static min_sup (+delta=alpha)       -> 2-D (sup x pos-sup) histogram
                                                 + alpha-level pattern records

Not ported yet (ROADMAP.md): the superstep trace ring (trace_period > 0),
the segmented checkpointable program (ckpt_period > 0) and multi-host
topologies; a config asking for them raises NotImplementedError.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.support_count.ops import resolve_impl
from repro_torch.stats import get_statistic

from .bitmap import (
    DEFAULT_ITEM_TILE,
    BitmapLayout,
    full_occ,
    item_tiling,
    num_words,
    pack_db,
    supports_np,
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
    #: the JAX Pallas kernel's block triple; the CUDA kernel's is fixed
    kernel_blocks: tuple[int, int, int] | None = None
    trace_period: int = 0          # superstep trace ring: not ported yet
    trace_cap: int = 0
    sync_period: int = 4           # supersteps between lambda/histogram syncs
    ckpt_period: int = 0           # segmented program: not ported yet
    topology: object | None = None  # multi-host topology: not ported yet


def _check_ported(cfg: EngineConfig) -> None:
    if cfg.trace_period > 0:
        raise NotImplementedError(
            "trace_period > 0: the superstep trace ring is not ported yet "
            "(ROADMAP.md queue 1, item 7: observability)"
        )
    if cfg.ckpt_period > 0:
        raise NotImplementedError(
            "ckpt_period > 0: the segmented checkpointable program is not "
            "ported yet (ROADMAP.md queue 1, item 8: fault tolerance)"
        )
    if cfg.topology is not None:
        raise NotImplementedError(
            "topology: multi-host meshes are not ported yet (ROADMAP.md "
            "queue 1, item 10: multi-process topology)"
        )
    if cfg.kernel_blocks is not None:
        raise ValueError("kernel_blocks: the CUDA kernel's tile is fixed; pass None")


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
    hist2d: np.ndarray | None = None  # [N+1, Npos+1] (mode="count2d")
    # emitted pattern records (modes "test"/"count2d"):
    sig_occ: np.ndarray | None = None   # [K, W]u32 occurrence bitmaps
    sig_core: np.ndarray | None = None  # [K] core item of the emitting node
    emit_dropped: int = 0          # records lost to out_cap saturation
    db_bits: np.ndarray | None = None  # [M, W]u32 packed DB (reused downstream)
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

    The host numpy arrays are the JAX PackedProblem's (root deal, closure
    reconstruction); `db_dev` [T, m_tile, W] and `pos_mask_dev` [W] hold
    the same bits as int32 on `device`.  Padded items/words/positives are
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
        """[m_pad, w_pad] item-major view (host-side: root deal, closures)."""
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


def deal_roots(packed: PackedProblem, n_proc: int, stack_cap: int, min_sup: int = 1):
    """Paper §4.5: expand the root on the host, deal depth-1 nodes round-robin
    (item e to miner e mod P, in ascending item order).

    Returns (init_occ [P,CAP,W] u32, init_meta [P,CAP,4] i32, init_sp [P] i32).
    """
    db_bits, occ0 = packed.db_bits, packed.occ0
    s = supports_np(occ0, db_bits)            # padded items have s == 0
    in_clo = s == packed.n
    cand = np.flatnonzero((~in_clo) & (s >= max(1, min_sup)))
    clo_cum = np.concatenate([[0], np.cumsum(in_clo)])  # clo_cum[e] = |clo ∩ [0,e)|

    init_occ = np.zeros((n_proc, stack_cap, packed.w_pad), dtype=np.uint32)
    init_meta = np.zeros((n_proc, stack_cap, 4), dtype=np.int32)
    init_sp = np.zeros(n_proc, dtype=np.int32)
    for p in range(n_proc):
        e = cand[cand % n_proc == p]
        if len(e) > stack_cap:
            raise ValueError(
                f"stack_cap={stack_cap} too small for the depth-1 preprocess "
                f"({len(e)} roots dealt to miner {p})"
            )
        init_occ[p, : len(e)] = occ0 & db_bits[e]
        init_meta[p, : len(e)] = np.stack(
            [e, clo_cum[e], s[e], np.zeros_like(e)], axis=1
        )
        init_sp[p] = len(e)
    return init_occ, init_meta, init_sp


class _Carry:
    """The BSP carry of all P miners: [P, ...] tensors on one device (the
    stacks and record buffers with a trailing spill row), lambda a 0-d
    tensor — it is uniform across miners, as in the JAX engine."""

    def __init__(self, *, init_occ, init_meta, init_sp, lam0, nb, snb, nb2,
                 out_cap, device):
        P, _, w = init_occ.shape
        i64 = torch.int64
        spill = torch.zeros((P, 1, w), dtype=torch.int32, device=device)
        self.occ_stack = torch.cat([words_to_tensor(init_occ, device), spill], dim=1)
        self.meta = torch.cat(
            [torch.from_numpy(np.ascontiguousarray(init_meta)).to(device),
             torch.zeros((P, 1, 4), dtype=torch.int32, device=device)], dim=1,
        )
        self.sp = torch.from_numpy(np.asarray(init_sp, np.int64)).to(device)
        self.head = torch.zeros(P, dtype=i64, device=device)
        self.hist = torch.zeros((P, nb), dtype=i64, device=device)
        self.hist_snap = torch.zeros((P, snb), dtype=i64, device=device)
        self.g_hist_acc = torch.zeros(snb, dtype=i64, device=device)
        self.hist2d = torch.zeros((P, nb2), dtype=i64, device=device)
        self.lam = torch.tensor(int(lam0), dtype=i64, device=device)
        self.stats = torch.zeros((P, _NSTAT), dtype=i64, device=device)
        self.out_occ = torch.zeros((P, out_cap + 1, w), dtype=torch.int32, device=device)
        self.out_meta = torch.zeros((P, out_cap + 1, 3), dtype=torch.int32, device=device)
        self.out_ptr = torch.zeros(P, dtype=i64, device=device)
        self.n_sig = torch.zeros(P, dtype=i64, device=device)


def build_mine_step(
    *, n: int, n_pos: int, m: int, cfg: EngineConfig, stack_cap: int,
    schedule: LifelineSchedule, mode: str, device,
    statistic: str | None = "fisher",
):
    """Wire the superstep phases into the BSP program for P miners.

    `n`/`n_pos`/`m` are the program dims; the dataset's actual counts are
    runtime arguments of the returned program.  The program runs the host
    superstep loop to termination and returns the raw 10-tuple of numpy
    arrays that `postprocess_phase` takes (the JAX program's outputs; the
    trace slot is always None).
    """
    _check_ported(cfg)
    device = torch.device(device)
    NB = n + 2
    NB2 = (n + 1) * (n_pos + 1) if mode == "count2d" else 1
    SNB = NB if mode == "lamp1" else 1
    n_proc = schedule.n_proc
    kernel_impl = resolve_impl(cfg.kernel_impl, device)
    expand = build_expand(n=n, n_pos=n_pos, m=m, cfg=cfg, stack_cap=stack_cap,
                          mode=mode, kernel_impl=kernel_impl, statistic=statistic)
    steal_round = build_steal_round(schedule, cfg, stack_cap=stack_cap, device=device)
    global_sync = build_global_sync(mode=mode, sync_period=cfg.sync_period)

    def program(init_occ, init_meta, init_sp, db_tiles, pos_mask, thr, lam0,
                delta, n_act, npos_act):
        st = _Carry(init_occ=init_occ, init_meta=init_meta, init_sp=init_sp,
                    lam0=lam0, nb=NB, snb=SNB, nb2=NB2, out_cap=cfg.out_cap,
                    device=device)
        thr_t = torch.from_numpy(np.asarray(thr, np.int64)).to(device)
        delta_t = torch.tensor(delta, dtype=torch.float32, device=device)
        t = 0
        # miners with work, read back once per superstep: the loop's only
        # device -> host sync
        work = n_proc - int(hunger_census(st.sp).sum())
        while work > 0 and t < cfg.max_steps:
            st.n_sig += expand(st, db_tiles, pos_mask, delta_t, n_act, npos_act)
            # the hunger census: REQUEST side of the steal exchange and the
            # exact termination test (steals only redistribute work)
            hungry_vec = hunger_census(st.sp)
            n_hungry = hungry_vec.sum()
            if cfg.steal_enabled:
                got, gave, k_given, _k_recv = steal_round(t, hungry_vec, st)
                st.stats[:, Stat.STEALS_GOT] += got
                st.stats[:, Stat.GIVES] += gave
                st.stats[:, Stat.STOLEN_NODES] += k_given
                st.stats[:, Stat.STEAL_ROUNDS] += (n_hungry > 0).long()
            st.stats[:, Stat.IDLE_STEPS] += (st.sp == 0).long()
            st.stats[:, Stat.SUPERSTEPS] += 1
            global_sync(t, st, thr_t)
            work = n_proc - int(n_hungry)
            t += 1
        # one exact full-histogram sum at termination
        i32 = np.int32
        out_cap = cfg.out_cap
        return (
            st.hist.sum(dim=0).cpu().numpy().astype(i32),
            int(st.lam),
            t,
            st.stats.cpu().numpy().astype(i32),
            tensor_to_words(st.out_occ[:, :out_cap]),
            st.out_meta[:, :out_cap].cpu().numpy(),
            st.out_ptr.cpu().numpy().astype(i32),
            int(st.n_sig.sum()),
            None,
            st.hist2d.sum(dim=0).cpu().numpy().astype(i32),
        )

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
):
    """Build the program argument tuple (and the postprocess context).

    Returns (args, ctx) with ctx = dict(thr, start_sup) for postprocess.
    """
    start_sup = min_sup if mode != "lamp1" else 1
    init_occ, init_meta, init_sp = deal_roots(packed, n_proc, stack_cap, start_sup)
    thr = _thresholds_int(packed.n, packed.n_pos, alpha, statistic)
    thr_pad = np.full(packed.n_pad + 2, INT_MAX, dtype=np.int32)
    thr_pad[: thr.shape[0]] = thr
    args = (
        init_occ, init_meta, init_sp,
        packed.db_dev, packed.pos_mask_dev, thr_pad,
        int(start_sup), float(np.float32(delta)),
        int(packed.n), int(packed.n_pos),
    )
    return args, dict(thr=thr_pad, start_sup=start_sup)


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
) -> MineOutput:
    """Program output -> MineOutput: slice padding, fold in the root closed
    set, gather emitted pattern records, surface overflow (the JAX
    `postprocess_phase`, host numpy)."""
    n, n_pos = packed.n, packed.n_pos
    root_sup = n  # support of the root closure == all transactions
    (g_hist, lam, t, stats, out_occ, out_meta, out_ptr, g_sig, _trace,
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
    if int(t) >= cfg.max_steps:
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

    return MineOutput(
        hist=g_hist,
        lam_final=int(lam),
        supersteps=int(t),
        stats=stats_dict,
        sig_count=n_sig,
        sig_sup=sig_sup,
        sig_pos_sup=sig_pos,
        hist2d=hist2d,
        sig_occ=sig_occ,
        sig_core=sig_core,
        emit_dropped=emit_dropped,
        db_bits=packed.db_bits,
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
) -> MineOutput:
    """Run one engine pass with `n_miners` virtual miners on one device.

    The one-shot low-level entry: packs the database (unless a prepared
    `packed` is given), runs the BSP program, and postprocesses.  It runs
    where `packed` lives, else on `device` (default: the card; without one
    it raises — pass device="cpu" to run on the CPU).
    """
    if mode not in VALID_MODES:
        raise ValueError(
            f"unknown engine mode {mode!r}; valid modes: {', '.join(VALID_MODES)}"
        )
    _check_ported(cfg)
    if n_miners < 1:
        raise ValueError(f"n_miners must be >= 1, got {n_miners}")
    if packed is None:
        packed = pack_problem(db_bool, labels, device=resolve_device(device))
    elif device is not None and resolve_device(device) != packed.device:
        raise ValueError(f"packed lives on {packed.device}, not on {device}")
    schedule = build_schedule(n_miners, cfg.n_random_perms, cfg.seed)
    stack_cap = resolve_stack_cap(cfg, packed.m_pad, packed.w_pad, n_miners)
    args, ctx = make_phase_args(
        packed, n_proc=n_miners, cfg=cfg, stack_cap=stack_cap, mode=mode,
        alpha=alpha, min_sup=min_sup, delta=delta, statistic=statistic,
    )
    program = build_mine_step(
        n=packed.n_pad, n_pos=packed.npos_pad, m=packed.m_pad, cfg=cfg,
        stack_cap=stack_cap, schedule=schedule, mode=mode,
        device=packed.device, statistic=statistic,
    )
    raw = program(*args)
    return postprocess_phase(
        raw, packed=packed, n_proc=n_miners, cfg=cfg, mode=mode,
        thr=ctx["thr"], start_sup=ctx["start_sup"], delta=delta,
        statistic=statistic,
    )
