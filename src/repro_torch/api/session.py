"""MinerSession — build-once, query-many pattern mining (counterpart of
`repro.api.session`).

A session owns one device, P virtual miners on it, and a bounded LRU cache
of BSP programs keyed by

    (mode, shape bucket, resolved RuntimeConfig, statistic)

— the JAX session's key.  A program here is the superstep loop that
`core.engine.build_mine_step` returns for those dims and that config,
together with its lifeline schedule; `compile_s` is the time to build it.
The statistic component is the registered test whose device P-value gates
emission in modes "test"/"count2d", so fisher and chi2 programs never
collide; modes "lamp1"/"count" key it as None, so every statistic shares
their programs.  Statistical parameters (alpha / min_sup / delta) and the
dataset's exact dims enter the program as runtime arguments, so a repeat
query — same dataset, or any dataset in the same bucket — is a cache hit
in every phase, and `cache_info()` exposes hits/misses/evictions.

Queries are first-class objects (api.query): `run(dataset, query)`
executes any registered objective, and `mine(...)` is a thin wrapper that
builds a SignificantPatternQuery from the session's AlgorithmConfig.  The
LAMP stagings (`PIPELINES`: "three_phase" | "fused23") are functions over a
session, sharing its packed dataset and warm programs across phases.

A session runs one query at a time; the program cache is lock-protected,
so `cache_info()`, `has_programs()`, `clear_cache()` and `warmup()` are
safe to call from other threads while a query runs.

With `RuntimeConfig.trace_period > 0` every phase report carries its
decoded superstep trace; with `ckpt_period > 0` phases run segmented, and
`run(ckpt_dir=, resume_from=, should_stop=)` checkpoints, resumes
(elastically, onto this session's miner count) and stops at a soft
deadline with a partial report (DESIGN.md §11).  `run(stream=...)`
delivers the final top-k head to a callback while the rest of the result
is still being reconstructed (the serving layer's top-k-first delivery).

Not ported yet (ROADMAP.md queue 1): multi-host topologies (`topology`,
item 10); asking for one raises NotImplementedError.
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable

import numpy as np

from repro_torch.core.engine import (
    VALID_MODES,
    EngineConfig,
    MineOutput,
    _check_ported,
    build_mine_step,
    make_program_args,
    postprocess_phase,
    run_segments,
    segments_raw_output,
)
from repro_torch.core.lifeline import build_schedule
from repro_torch.device import resolve_device
from repro_torch.obs import MetricsRegistry, SpanTracer
from repro_torch.stats import get_statistic

from .config import AlgorithmConfig, RuntimeConfig
from .dataset import Dataset, ShapeBucket
from .query import Query, SignificantPatternQuery
from .report import MineReport, PhaseReport

__all__ = ["CacheInfo", "MinerSession", "PIPELINES", "PIPELINE_MODES",
           "ProgramInfo"]

#: engine modes each LAMP staging runs — what "fully warm for a bucket"
#: means to `has_programs` / `warmup`
PIPELINE_MODES: dict[str, tuple[str, ...]] = {
    "three_phase": ("lamp1", "count", "test"),
    "fused23": ("lamp1", "count2d"),
}

#: sentinel distinguishing "argument omitted" from an explicit None —
#: statistic=None elsewhere means "no test", which mine() must reject
_USE_SESSION_DEFAULT = "<session-default>"


@dataclass(frozen=True)
class ProgramInfo:
    """Build stats for one cached program."""

    mode: str
    bucket: ShapeBucket
    compile_s: float       # time to build the program
    calls: int
    flops: float | None    # no cost analysis here: always None
    statistic: str | None = None  # emission test ("test"/"count2d" only)


@dataclass(frozen=True)
class CacheInfo:
    """Snapshot of the session's program cache."""

    hits: int
    misses: int
    programs: tuple[ProgramInfo, ...]
    evictions: int = 0   # programs dropped by the max_programs LRU bound

    @property
    def n_programs(self) -> int:
        return len(self.programs)

    def __str__(self) -> str:
        lines = [f"cache: {self.hits} hits / {self.misses} misses, "
                 f"{self.n_programs} programs"
                 + (f", {self.evictions} evicted" if self.evictions else "")]
        for p in self.programs:
            stat = f" stat={p.statistic}" if p.statistic is not None else ""
            lines.append(
                f"  [{p.mode:8s}]{stat} bucket=({p.bucket.transactions}, "
                f"{p.bucket.positives}, {p.bucket.items}) "
                f"compile={p.compile_s:.2f}s calls={p.calls}"
            )
        return "\n".join(lines)


class _Program:
    __slots__ = ("compiled", "compile_s", "flops", "calls")

    def __init__(self, compiled, compile_s: float, flops: float | None):
        self.compiled = compiled
        self.compile_s = compile_s
        self.flops = flops
        self.calls = 0


class MinerSession:
    """A persistent miner: one device, P virtual miners, one program cache."""

    def __init__(
        self,
        n_miners: int = 1,
        *,
        device=None,
        algorithm: AlgorithmConfig | None = None,
        runtime: RuntimeConfig | None = None,
        tracer: SpanTracer | None = None,
        metrics: MetricsRegistry | None = None,
    ):
        if n_miners < 1:
            raise ValueError(f"n_miners must be >= 1, got {n_miners}")
        self.device = resolve_device(device)
        self.n_miners = int(n_miners)
        self.algorithm = algorithm or AlgorithmConfig()
        self.runtime = runtime or RuntimeConfig()
        r = self.runtime
        # the engine's refusal of unported options, raised before any query
        _check_ported(EngineConfig(topology=r.topology,
                                   kernel_blocks=r.kernel_blocks))
        self.tracer = tracer or SpanTracer()
        self.metrics = metrics or MetricsRegistry()
        m = self.metrics
        self._m_hits = m.counter(
            "miner_cache_hits_total", "compiled-program cache hits")
        self._m_misses = m.counter(
            "miner_cache_misses_total", "compiled-program cache misses")
        self._m_evictions = m.counter(
            "miner_cache_evictions_total", "programs evicted by the LRU bound")
        self._m_programs = m.gauge(
            "miner_cached_programs", "compiled programs currently cached")
        self._m_compile = m.histogram(
            "miner_compile_seconds", "phase-program compile latency")
        self._m_phase = m.histogram(
            "miner_phase_seconds", "engine phase wall time", labels=("mode",))
        self._m_query = m.histogram(
            "miner_query_seconds", "full query wall time", labels=("query",))
        self._m_emit_drop = m.counter(
            "miner_emit_dropped_total",
            "pattern records lost to out_cap saturation")
        self._m_trace_drop = m.counter(
            "miner_trace_dropped_total",
            "superstep trace records lost to ring wrap")
        self._m_ckpt_write = m.histogram(
            "miner_ckpt_write_seconds", "frontier checkpoint write latency")
        self._m_ckpt_restore = m.histogram(
            "miner_ckpt_restore_seconds",
            "frontier checkpoint restore (incl. reshard) latency")
        self._m_ckpt_bytes = m.counter(
            "miner_ckpt_bytes_total", "frontier checkpoint payload bytes")
        if self.runtime.max_programs < 1:
            raise ValueError(
                f"RuntimeConfig.max_programs must be >= 1, got "
                f"{self.runtime.max_programs} (the session needs room for at "
                "least the program it is about to run)"
            )
        # insertion/use-ordered: front = least recently used (LRU eviction)
        self._programs: OrderedDict[tuple, _Program] = OrderedDict()
        self._schedules: dict[tuple[int, int], object] = {}
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        # guards the program cache + counters only (queries stay single-
        # threaded per session)
        self._cache_lock = threading.RLock()
        # one-shot fault-tolerance state installed by run(ckpt_dir=...,
        # resume_from=..., should_stop=...), consumed by run_phase, cleared
        # in run()'s finally.  _phase_seq numbers the phases of the current
        # query, so each checkpoints into its own "<seq>_<mode>" subdir and
        # a resumed query lines its phases back up.
        self._ckpt_dir = None
        self._resume_from = None
        self._should_stop = None
        self._phase_seq = 0
        # one-shot ResultStream installed by run(stream=...), consumed by
        # the first _build_results of the query, cleared in run()'s finally
        self._stream = None

    @property
    def n_devices(self) -> int:
        """The miner count, under the JAX session's name (one miner per
        device there); the serving layer and launchers read it."""
        return self.n_miners

    # -------------------------------------------------------------- programs
    def _schedule(self, cfg: EngineConfig):
        key = (cfg.n_random_perms, cfg.seed)
        if key not in self._schedules:
            self._schedules[key] = build_schedule(
                self.n_miners, cfg.n_random_perms, cfg.seed
            )
        return self._schedules[key]

    def _resolve(self, bucket: ShapeBucket) -> EngineConfig:
        return self.runtime.resolve(bucket, self.n_miners, self.device)

    def _program(self, mode: str, bucket: ShapeBucket, cfg: EngineConfig,
                 statistic: str | None):
        """Fetch-or-build the phase program for (mode, bucket, cfg, stat).

        The build runs outside the cache lock; a concurrent build of the
        same key is a benign race — first insert wins.
        """
        key = (mode, bucket, cfg, statistic)
        with self._cache_lock:
            entry = self._programs.get(key)
            if entry is not None:
                self._hits += 1
                self._m_hits.inc()
                self._programs.move_to_end(key)  # most recently used
                return entry, True
            self._misses += 1
            self._m_misses.inc()
        t0 = time.perf_counter()
        with self.tracer.span("compile", mode=mode, statistic=statistic):
            program = build_mine_step(
                n=bucket.transactions, n_pos=bucket.positives, m=bucket.items,
                cfg=cfg, stack_cap=cfg.stack_cap, schedule=self._schedule(cfg),
                mode=mode, device=self.device, statistic=statistic,
            )
        compile_s = time.perf_counter() - t0
        self._m_compile.observe(compile_s)
        entry = _Program(program, compile_s, None)
        with self._cache_lock:
            existing = self._programs.get(key)
            if existing is not None:  # another thread won the build race
                self._programs.move_to_end(key)
                return existing, True
            self._programs[key] = entry
            while len(self._programs) > self.runtime.max_programs:
                self._programs.popitem(last=False)  # evict least recently used
                self._evictions += 1
                self._m_evictions.inc()
            self._m_programs.set(len(self._programs))
        return entry, False

    def cache_info(self) -> CacheInfo:
        with self._cache_lock:
            return CacheInfo(
                hits=self._hits,
                misses=self._misses,
                evictions=self._evictions,
                programs=tuple(
                    ProgramInfo(mode=key[0], bucket=key[1],
                                compile_s=p.compile_s, calls=p.calls,
                                flops=p.flops, statistic=key[3])
                    for key, p in self._programs.items()
                ),
            )

    def clear_cache(self) -> int:
        """Drop every cached program; returns how many were held.

        Hit/miss/eviction counters are preserved (a clear is not an LRU
        eviction); the next query of any (mode, bucket, statistic) rebuilds.
        """
        with self._cache_lock:
            n = len(self._programs)
            self._programs.clear()
            return n

    # --------------------------------------------------------------- warmup
    def _pipeline_modes(self, pipeline: str | None) -> tuple[str, ...]:
        pipeline = pipeline or self.algorithm.pipeline
        try:
            return PIPELINE_MODES[pipeline]
        except KeyError:
            raise ValueError(
                f"unknown pipeline {pipeline!r}; available: "
                f"{sorted(PIPELINE_MODES)}"
            ) from None

    def has_programs(
        self,
        bucket: ShapeBucket,
        statistic: str | None = _USE_SESSION_DEFAULT,
        *,
        pipeline: str | None = None,
    ) -> bool:
        """True when every phase program `pipeline` needs for this bucket
        (under `statistic`) is already cached — a significant-pattern query
        on any same-bucket dataset would dispatch fully warm."""
        if statistic is _USE_SESSION_DEFAULT:
            statistic = self.algorithm.statistic
        modes = self._pipeline_modes(pipeline)
        cfg = self._resolve(bucket)
        with self._cache_lock:
            return all(
                (mode, bucket, cfg,
                 statistic if mode in ("test", "count2d") else None)
                in self._programs
                for mode in modes
            )

    def warmup(
        self,
        target,
        *,
        statistic: str | None = _USE_SESSION_DEFAULT,
        pipeline: str | None = None,
        alpha: float | None = None,
    ) -> int:
        """Build every phase program for a bucket before traffic needs it.

        `target` is a `ShapeBucket` or a `Dataset` (its bucket is warmed).
        Returns the number of programs actually built (0 = already warm).
        A program — classic or segmented, as `ckpt_period` selects —
        depends on the bucket and config only, so no data is packed;
        `alpha` is accepted for the JAX signature and unused.
        """
        if statistic is _USE_SESSION_DEFAULT:
            statistic = self.algorithm.statistic
        if statistic is not None:
            get_statistic(statistic)  # actionable ValueError on typos
        modes = self._pipeline_modes(pipeline)
        bucket = target.bucket if isinstance(target, Dataset) else target
        if not isinstance(bucket, ShapeBucket):
            raise TypeError(
                f"warmup() takes a ShapeBucket or a Dataset, got "
                f"{type(target).__name__}"
            )
        cfg = self._resolve(bucket)
        built = 0
        with self.tracer.span("warmup", statistic=statistic, bucket=str(bucket)):
            for mode in modes:
                stat_key = statistic if mode in ("test", "count2d") else None
                _, hit = self._program(mode, bucket, cfg, stat_key)
                built += 0 if hit else 1
        return built

    # ---------------------------------------------------------------- phases
    def run_phase(
        self,
        dataset: Dataset,
        mode: str,
        *,
        min_sup: int = 1,
        delta: float = 0.0,
        alpha: float | None = None,
        statistic: str | None = "fisher",
    ) -> PhaseReport:
        """One engine pass on a warm (or newly built) program.

        `statistic` names the registered test gating emission in modes
        "test"/"count2d" (None emits every counted closed set — the
        closed-frequent objective); modes "lamp1"/"count" use it only for
        the host-built Tarone threshold table, so their programs are shared
        across statistics.
        """
        if mode not in VALID_MODES:
            raise ValueError(
                f"unknown engine mode {mode!r}; valid modes: "
                f"{', '.join(VALID_MODES)}"
            )
        if dataset.packed.device != self.device:
            raise ValueError(
                f"dataset {dataset.name!r} lies on {dataset.packed.device} but "
                f"this session runs on {self.device}; build the Dataset with "
                f"device={str(self.device)!r}"
            )
        if statistic is not None:
            get_statistic(statistic)  # actionable ValueError on typos
        t0 = time.perf_counter()
        alpha = self.algorithm.alpha if alpha is None else alpha
        partial = resumed = False
        ckpt = {"writes": 0, "bytes": 0, "path": None}
        with self.tracer.span(f"phase:{mode}", dataset=dataset.name):
            cfg = self._resolve(dataset.bucket)
            if (self._ckpt_dir or self._resume_from) and cfg.ckpt_period <= 0:
                raise ValueError(
                    "ckpt_dir/resume_from need the segmented program: set "
                    "RuntimeConfig.ckpt_period > 0"
                )
            with self.tracer.span("pack"):
                args, ctx = make_program_args(
                    dataset.packed, n_proc=self.n_miners, cfg=cfg, mode=mode,
                    alpha=alpha, min_sup=min_sup, delta=delta,
                    statistic=statistic,
                )
            # the statistic gates only the emission of "test"/"count2d";
            # lamp1/count programs are statistic-free, shared under None
            stat_key = statistic if mode in ("test", "count2d") else None
            entry, hit = self._program(mode, dataset.bucket, cfg, stat_key)
            with self.tracer.span("dispatch", cache_hit=hit):
                if cfg.ckpt_period > 0:
                    raw, partial, resumed = self._run_segmented(
                        entry, dataset, cfg, mode=mode, alpha=alpha,
                        delta=delta, statistic=statistic, ctx=ctx, ckpt=ckpt,
                    )
                else:
                    raw = entry.compiled(*args)
            with self.tracer.span("postprocess"):
                out = postprocess_phase(
                    raw, packed=dataset.packed, n_proc=self.n_miners, cfg=cfg,
                    mode=mode, thr=ctx["thr"], start_sup=ctx["start_sup"],
                    delta=delta, statistic=statistic, partial=partial,
                    schedule=self._schedule(cfg),
                )
        entry.calls += 1
        wall_s = time.perf_counter() - t0
        self._m_phase.labels(mode=mode).observe(wall_s)
        if out.emit_dropped:
            self._m_emit_drop.inc(out.emit_dropped)
        if out.trace_dropped:
            self._m_trace_drop.inc(out.trace_dropped)
        return PhaseReport(
            mode=mode,
            wall_s=wall_s,
            compile_s=0.0 if hit else entry.compile_s,
            cache_hit=hit,
            supersteps=out.supersteps,
            lam_final=out.lam_final,
            n_nodes=int(out.stats["popped"].sum()),
            steals=int(out.stats["steals_got"].sum()),
            # gated rounds actually executed: per-miner counters are all
            # equal (the census is replicated), so read miner 0's
            steal_rounds=int(out.stats["steal_rounds"][0]),
            emit_dropped=out.emit_dropped,
            output=out,
            kernel_impl=cfg.kernel_impl,
            kernel_blocks=cfg.kernel_blocks,
            item_tile=dataset.bucket.item_tile,
            n_item_tiles=dataset.bucket.n_tiles,
            trace=out.trace,
            trace_dropped=out.trace_dropped,
            steal_by_round=(out.trace.steal_by_round()
                            if out.trace is not None else None),
            tier_fairness=(out.trace.tier_fairness()
                           if out.trace is not None else None),
            partial=partial,
            resumed=resumed,
            ckpt_writes=ckpt["writes"],
            ckpt_bytes=ckpt["bytes"],
            ckpt_path=ckpt["path"],
        )

    def _run_segmented(self, entry, dataset, cfg, *, mode, alpha, delta,
                       statistic, ctx, ckpt):
        """Drive one phase through the segmented program (DESIGN.md §11).

        Resumes the frontier from `self._resume_from` (elastically resharded
        onto this session's miner count), checkpoints every segment into a
        per-phase "<seq>_<mode>" subdir of `self._ckpt_dir`, and stops
        cooperatively when `self._should_stop()` fires at a segment
        boundary.  The carry stays on the device between segments and
        comes to the host only for a checkpoint write.  Returns (raw
        10-tuple, partial, resumed).
        """
        from repro_torch.ckpt import mining as ckpt_mining

        tag = f"{self._phase_seq:02d}_{mode}"
        self._phase_seq += 1
        provenance = ckpt_mining.make_provenance(
            dataset.packed, mode=mode, statistic=statistic, alpha=alpha,
            start_sup=ctx["start_sup"], delta=delta,
        )
        carry = ctx["carry0"]
        resumed = False
        if self._resume_from:
            t0r = time.perf_counter()
            restored = ckpt_mining.restore_frontier(
                os.path.join(self._resume_from, tag), provenance=provenance,
                n_proc=self.n_miners, cfg=cfg, mode=mode,
            )
            self._m_ckpt_restore.observe(time.perf_counter() - t0r)
            if restored is not None:
                carry = restored
                resumed = True
        on_segment = None
        if self._ckpt_dir:
            phase_dir = os.path.join(self._ckpt_dir, tag)

            def on_segment(c):
                t0w = time.perf_counter()
                path, nbytes = ckpt_mining.save_frontier(
                    c.to_fields(), phase_dir, provenance=provenance,
                )
                self._m_ckpt_write.observe(time.perf_counter() - t0w)
                self._m_ckpt_bytes.inc(nbytes)
                ckpt["writes"] += 1
                ckpt["bytes"] += nbytes
                ckpt["path"] = path

        carry, partial = run_segments(
            entry.compiled, carry, cfg=cfg, static=ctx["static"],
            should_stop=self._should_stop, on_segment=on_segment,
        )
        return segments_raw_output(carry), partial, resumed

    # --------------------------------------------------------------- queries
    def run(self, dataset: Dataset, query: Query, *, stream=None,
            ckpt_dir: str | None = None, resume_from: str | None = None,
            should_stop=None) -> MineReport:
        """Execute one first-class query object (api.query).

        `stream` (a `repro_torch.results.ResultStream`) delivers the final
        top-`head_k` patterns to a callback *during* result construction —
        before full reconstruction finishes — for the serving layer's
        top-k-first delivery (DESIGN.md §10).  The returned report is
        identical with or without it.

        Fault tolerance (DESIGN.md §11; requires RuntimeConfig.ckpt_period
        > 0): `ckpt_dir` checkpoints each phase's frontier every segment;
        `resume_from` (usually a previous run's ckpt_dir, written by this
        package or the JAX one) restores every phase that has a valid
        checkpoint — elastically resharded onto this session's miner count
        — and the resumed query's ResultSet is bit-identical to an
        uninterrupted run; `should_stop()` polled at segment boundaries
        stops the query cooperatively, returning a partial MineReport
        (report.partial, results.complete == False) plus the checkpoint
        path to resume from.  `should_stop` is ignored when ckpt_period ==
        0 (the classic loop has no boundary to stop at).
        """
        if not isinstance(query, Query):
            raise TypeError(
                f"run() takes a repro_torch.api.Query (e.g. "
                f"SignificantPatternQuery(alpha=0.05)), got {type(query).__name__}"
            )
        if (ckpt_dir or resume_from) and not self.runtime.ckpt_period:
            raise ValueError(
                "ckpt_dir/resume_from need the segmented program: set "
                "RuntimeConfig.ckpt_period > 0"
            )
        t0 = time.perf_counter()
        self._stream = stream
        self._ckpt_dir = ckpt_dir
        self._resume_from = resume_from
        self._should_stop = should_stop if self.runtime.ckpt_period else None
        self._phase_seq = 0
        try:
            with self.tracer.span(f"query:{type(query).__name__}",
                                  dataset=dataset.name):
                report = query.run(self, dataset)
        finally:
            self._stream = None
            self._ckpt_dir = None
            self._resume_from = None
            self._should_stop = None
            self._phase_seq = 0
        self._m_query.labels(query=report.query).observe(
            time.perf_counter() - t0
        )
        return report

    def mine(
        self,
        dataset: Dataset,
        *,
        alpha: float | None = None,
        pipeline: str | None = None,
        statistic: str = _USE_SESSION_DEFAULT,
    ) -> MineReport:
        """Answer one significant-pattern query (full LAMP staging).

        Thin wrapper: builds a `SignificantPatternQuery` from the session's
        AlgorithmConfig defaults and runs it.  An explicit `statistic=None`
        is rejected — an untested enumeration is `ClosedFrequentQuery`.
        """
        if statistic is None:
            raise ValueError(
                "mine(statistic=None) is ambiguous: significance mining "
                "needs a registered statistic (omit the argument for the "
                "session default); for an untested closed-frequent "
                "enumeration use run(dataset, ClosedFrequentQuery(min_sup=...))"
            )
        query = SignificantPatternQuery(
            alpha=self.algorithm.alpha if alpha is None else alpha,
            statistic=(self.algorithm.statistic
                       if statistic is _USE_SESSION_DEFAULT else statistic),
            pipeline=self.algorithm.pipeline if pipeline is None else pipeline,
        )
        return self.run(dataset, query)

    def _build_results(self, dataset: Dataset, phase_out: MineOutput, *,
                       alpha, min_sup, k, delta, filter_host,
                       statistic: str | None = "fisher", records=None):
        """Emitted records of one phase output -> ResultSet (results).

        `records=(occ, sup, pos_sup)` overrides the phase output's emitted
        arrays (used to append host-side records, e.g. the root closed set).
        Closure reconstruction counts supports with the session's resolved
        kernel, as EXPAND does.
        """
        from repro_torch.results import build_result_set

        occ, sup, pos_sup = (
            (phase_out.sig_occ, phase_out.sig_sup, phase_out.sig_pos_sup)
            if records is None else records
        )
        # consume the one-shot stream installed by run(stream=...) — a
        # multi-phase pipeline builds results exactly once, at the end
        stream, self._stream = self._stream, None
        # the dataset was packed and uploaded exactly once; reconstruction
        # counts against its resident words (the whole [m_pad, W] tensor,
        # so it starts on the allocation's 16-byte boundary)
        packed = dataset.packed
        db_words = packed.db_dev.view(packed.m_pad, packed.w_pad)
        with self.tracer.span("reconstruct", n_records=len(sup)):
            return build_result_set(
                occ, sup, pos_sup, db_words,
                n=dataset.n_transactions, n_pos=dataset.n_pos, alpha=alpha,
                min_sup=min_sup, correction_factor=k, delta=delta,
                filter_host=filter_host, dropped=phase_out.emit_dropped,
                item_names=dataset.item_names, statistic=statistic,
                impl=self._resolve(dataset.bucket).kernel_impl,
                stream=stream,
            )

    def _root_record(self, dataset: Dataset, phase_out: MineOutput,
                     statistic: str | None, delta: float, min_sup: int):
        """Emitted records + the root closed set, when the run counts it.

        The root never transits the device buffers; `postprocess_phase`
        counts it host-side (same support guard, same test), so the pattern
        list appends it under exactly the same conditions: root support
        n >= min_sup, and — for a testing run — labels present with the
        statistic's root P-value <= delta.  statistic=None is the
        closed-frequent objective: the support guard alone decides.
        Returns None (caller keeps the device records as-is) when the root
        does not qualify.
        """
        n, n_pos = dataset.n_transactions, dataset.n_pos
        if n < min_sup:
            return None  # postprocess's root_sup >= start_sup guard
        if statistic is not None:
            if dataset.labels is None or float(
                get_statistic(statistic).pvalue(n, n_pos, n, n_pos)[0]
            ) > delta:
                return None
        return (
            np.concatenate([phase_out.sig_occ,
                            dataset.packed.occ0[None, :]], axis=0),
            np.concatenate([phase_out.sig_sup, [n]]),
            np.concatenate([phase_out.sig_pos_sup,
                            [n_pos if dataset.labels is not None else 0]]),
        )

    def _partial_mine_report(
        self, dataset: Dataset, phases, *, pipeline: str, query_tag: str,
        alpha: float, statistic: str | None, t0: float, min_sup: int = 0,
        k: int = 0, delta: float = float("nan"), lam: int | None = None,
        filter_host: bool = False,
    ) -> MineReport:
        """A MineReport for a query stopped at a soft deadline (§11).

        The last phase is the one that stopped; its emitted-so-far records
        (modes "test"/"count2d") become a truncated ResultSet — the root
        record is *not* folded in (the run never finished deciding it).
        Phases that emit nothing (lamp1/count) yield an empty truncated
        ResultSet.  LAMP quantities the stopped staging never derived stay
        at their NaN/0 placeholders.
        """
        from repro_torch.results import ResultSet

        ph = phases[-1]
        out = ph.output
        if out.sig_occ is not None and len(out.sig_occ):
            results = self._build_results(
                dataset, out, alpha=alpha, min_sup=min_sup, k=max(k, 1),
                delta=(alpha if math.isnan(delta) else delta),
                filter_host=filter_host, statistic=statistic,
            )
        else:
            self._stream = None  # the one-shot stream has nothing to carry
            results = ResultSet(
                n_transactions=dataset.n_transactions, n_pos=dataset.n_pos,
                alpha=alpha, min_sup=min_sup, correction_factor=max(k, 1),
                delta=delta, statistic=statistic,
                item_names=dataset.item_names,
            )
        results.truncated = True
        return MineReport(
            dataset=dataset.name,
            pipeline=pipeline,
            alpha=alpha,
            lambda_final=ph.lam_final if lam is None else lam,
            min_sup=min_sup,
            correction_factor=k,
            delta=delta,
            n_significant=out.sig_count,
            results=results,
            phases=tuple(phases),
            wall_s=time.perf_counter() - t0,
            statistic=statistic,
            query=query_tag,
            partial=True,
            ckpt_path=ph.ckpt_path,
        )


# -------------------------------------------------------------- pipelines
def _pipeline_three_phase(session: MinerSession, dataset: Dataset,
                          query: SignificantPatternQuery) -> MineReport:
    """The paper's §3.3 staging: lamp1 -> count -> test (three traversals)."""
    t0 = time.perf_counter()
    alpha, statistic = query.alpha, query.statistic
    ph1 = session.run_phase(dataset, "lamp1", alpha=alpha, statistic=statistic)
    if ph1.partial:  # soft deadline mid-lambda-search: nothing emitted yet
        return session._partial_mine_report(
            dataset, [ph1], pipeline="three_phase", query_tag="significant",
            alpha=alpha, statistic=statistic, t0=t0,
        )
    min_sup = max(ph1.lam_final - 1, session.algorithm.min_sup_floor)

    # phase 2: exact closed-set count at min_sup
    ph2 = session.run_phase(dataset, "count", min_sup=min_sup, alpha=alpha,
                            statistic=statistic)
    if ph2.partial:
        return session._partial_mine_report(
            dataset, [ph1, ph2], pipeline="three_phase",
            query_tag="significant", alpha=alpha, statistic=statistic, t0=t0,
            min_sup=min_sup, lam=ph1.lam_final,
        )
    k = int(ph2.output.hist[min_sup:].sum())
    delta = alpha / max(k, 1)
    # phase 3: significance testing at delta
    ph3 = session.run_phase(dataset, "test", min_sup=min_sup, delta=delta,
                            alpha=alpha, statistic=statistic)
    if ph3.partial:  # records emitted so far are already delta-filtered
        return session._partial_mine_report(
            dataset, [ph1, ph2, ph3], pipeline="three_phase",
            query_tag="significant", alpha=alpha, statistic=statistic, t0=t0,
            min_sup=min_sup, k=k, delta=delta, lam=ph1.lam_final,
        )
    # the device already filtered at delta; reconstruct + exact stats only
    # (the root closed set is appended iff the statistic counts it — it is
    # in ph3's n_sig exactly when significant, so list and count agree)
    results = session._build_results(
        dataset, ph3.output, alpha=alpha, min_sup=min_sup, k=k, delta=delta,
        filter_host=False, statistic=statistic,
        records=session._root_record(dataset, ph3.output, statistic, delta,
                                     min_sup),
    )
    return MineReport(
        dataset=dataset.name,
        pipeline="three_phase",
        alpha=alpha,
        lambda_final=ph1.lam_final,
        min_sup=min_sup,
        correction_factor=k,
        delta=delta,
        n_significant=ph3.output.sig_count,
        results=results,
        phases=(ph1, ph2, ph3),
        wall_s=time.perf_counter() - t0,
        statistic=statistic,
    )


def _pipeline_fused23(session: MinerSession, dataset: Dataset,
                      query: SignificantPatternQuery) -> MineReport:
    """Beyond-paper: lamp1 -> count2d, two traversals.

    One enumeration pass builds a 2-D (support x pos-support) histogram;
    P-values depend only on that pair, so the correction factor AND the
    significant count both fall out of the histogram — the third engine
    pass disappears.  The same pass emits alpha-level pattern records
    (delta <= alpha always), which the host filters down to the exact final
    delta, so pattern identities survive the fusion too.
    """
    t0 = time.perf_counter()
    alpha, statistic = query.alpha, query.statistic
    stat = get_statistic(statistic)
    ph1 = session.run_phase(dataset, "lamp1", alpha=alpha, statistic=statistic)
    if ph1.partial:  # soft deadline mid-lambda-search: nothing emitted yet
        return session._partial_mine_report(
            dataset, [ph1], pipeline="fused23", query_tag="significant",
            alpha=alpha, statistic=statistic, t0=t0,
        )
    min_sup = max(ph1.lam_final - 1, session.algorithm.min_sup_floor)

    n, n_pos = dataset.n_transactions, dataset.n_pos
    ph2 = session.run_phase(dataset, "count2d", min_sup=min_sup, delta=alpha,
                            alpha=alpha, statistic=statistic)
    if ph2.partial:  # emitted-so-far records are an alpha-level superset;
        # the exact final delta is unknown, so keep the superset (k=0 tags
        # the correction as underived)
        return session._partial_mine_report(
            dataset, [ph1, ph2], pipeline="fused23", query_tag="significant",
            alpha=alpha, statistic=statistic, t0=t0, min_sup=min_sup,
            lam=ph1.lam_final, delta=alpha, filter_host=True,
        )
    h2 = ph2.output.hist2d
    sups_grid = np.arange(n + 1)
    mask = (h2 > 0) & (sups_grid[:, None] >= min_sup)
    k = int(h2[mask].sum())
    delta = alpha / max(k, 1)
    xs, ns = np.nonzero(mask)
    pv = stat.pvalue(xs, ns, n, n_pos) if len(xs) else np.zeros(0)
    sig_mask = pv <= delta
    n_sig = int(h2[xs[sig_mask], ns[sig_mask]].sum()) if len(xs) else 0
    # records were emitted at the alpha superset level; exact-filter at delta
    # (root appended iff significant — the 2-D histogram counted it then)
    results = session._build_results(
        dataset, ph2.output, alpha=alpha, min_sup=min_sup, k=k, delta=delta,
        filter_host=True, statistic=statistic,
        records=session._root_record(dataset, ph2.output, statistic, delta,
                                     min_sup),
    )
    return MineReport(
        dataset=dataset.name,
        pipeline="fused23",
        alpha=alpha,
        lambda_final=ph1.lam_final,
        min_sup=min_sup,
        correction_factor=k,
        delta=delta,
        n_significant=n_sig,
        results=results,
        phases=(ph1, ph2),
        wall_s=time.perf_counter() - t0,
        statistic=statistic,
    )


#: First-class LAMP staging registry — selected by
#: `SignificantPatternQuery.pipeline` (and `MinerSession.mine(pipeline=...)`);
#: extend by registering a `(session, dataset, query) -> MineReport` here.
PIPELINES: dict[
    str, Callable[[MinerSession, Dataset, SignificantPatternQuery], MineReport]
] = {
    "three_phase": _pipeline_three_phase,
    "fused23": _pipeline_fused23,
}
