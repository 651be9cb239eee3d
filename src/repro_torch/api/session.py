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

`RuntimeConfig.topology` (a `repro_torch.topo.Topology` of n_miners
miners) runs the hierarchical two-level lifeline schedule instead of the
flat one.  Inside a `torch.distributed` group of several processes
(`repro_torch.topo.bootstrap.init_distributed`) `n_miners` counts the
*global* miners, as the JAX session's device count does: each process
runs its contiguous block of them, and every process returns the same
report (DESIGN.md §12).  Segmented passes (`ckpt_period > 0`) are refused
there, as in the JAX package.
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Callable

import numpy as np

from repro_torch.core.collectives import process_group
from repro_torch.core.engine import (
    VALID_MODES,
    EngineConfig,
    MineOutput,
    build_mine_step,
    make_phase_args,
    make_schedule,
    postprocess_phase,
    run_segments,
)
from repro_torch.core.stats import Stat
from repro_torch.device import resolve_device
from repro_torch.obs import MetricsRegistry, SpanTracer
from repro_torch.stats import gate_rtol, get_statistic

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
        # the engine's refusal of a topology of another miner count, raised
        # before any query
        make_schedule(EngineConfig(topology=r.topology), self.n_miners)
        #: this process's block of the miners in a multi-process group,
        #: None in a single process
        self.group = process_group(self.n_miners)
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
        self._m_gate_band = m.counter(
            "miner_gate_band_records_total",
            "records a widened device gate emitted that the host's float64 "
            "test then dropped")
        self._m_replays = m.counter(
            "miner_superstep_replays_total",
            "supersteps run as one replay of a CUDA graph")
        self._m_graphs = m.counter(
            "miner_superstep_graphs_total",
            "superstep CUDA graphs captured")
        self._m_trace_drop = m.counter(
            "miner_trace_dropped_total",
            "superstep trace records lost to ring wrap")
        self._m_span_drop = m.counter(
            "miner_spans_dropped_total",
            "host span events lost to the span tracer's ring")
        # (tracer, its `dropped` already exported): the tracer may be
        # swapped for another between queries
        self._span_drops_seen = (self.tracer, 0)
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
        self._schedules: dict[tuple, object] = {}
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
        # numbers this session's queries (the `qid` of each query span)
        self._qid = 0

    @property
    def n_devices(self) -> int:
        """The miner count, under the JAX session's name (one miner per
        device there); the serving layer and launchers read it."""
        return self.n_miners

    # -------------------------------------------------------------- programs
    def _schedule(self, cfg: EngineConfig):
        key = (cfg.n_random_perms, cfg.seed, cfg.topology)
        if key not in self._schedules:
            self._schedules[key] = make_schedule(cfg, self.n_miners)
        return self._schedules[key]

    def _resolve(self, bucket: ShapeBucket) -> EngineConfig:
        n_local = self.group.n_local if self.group is not None else None
        return self.runtime.resolve(bucket, self.n_miners, self.device, n_local)

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
                # run_phase refuses a segmented pass across processes
                group=self.group if cfg.ckpt_period == 0 else None,
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
        A program (its segment length `ckpt_period` part of the config)
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
        band: float = 0.0,
    ) -> PhaseReport:
        """One engine pass on a warm (or newly built) program.

        `statistic` names the registered test gating emission in modes
        "test"/"count2d" (None emits every counted closed set — the
        closed-frequent objective); modes "lamp1"/"count" use it only for
        the host-built Tarone threshold table, so their programs are shared
        across statistics.  `band` widens the device gate to
        delta * exp(band): the pass emits a superset for the host to decide
        at delta, which stays the level of the checkpoint provenance and of
        the root's host test.
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
        resumed = False
        ckpt = {"writes": 0, "bytes": 0, "path": None}
        with self.tracer.span(f"phase:{mode}", dataset=dataset.name):
            cfg = self._resolve(dataset.bucket)
            with self.tracer.span("pack"):
                deal, ctx = make_phase_args(
                    dataset.packed, n_proc=self.n_miners, cfg=cfg,
                    stack_cap=cfg.stack_cap, mode=mode, alpha=alpha,
                    min_sup=min_sup, delta=delta * math.exp(band),
                    statistic=statistic, tracer=self.tracer,
                )
            if self.group is not None:
                # every process dealt the same global roots; keep this
                # process's rows (repro_torch.topo.bootstrap)
                from repro_torch.topo import bootstrap

                if cfg.ckpt_period > 0:
                    raise NotImplementedError(
                        "segmented (ckpt_period > 0) passes are not yet "
                        "supported under a multi-process mesh: the per-"
                        "segment host round-trip of the carry needs "
                        "allgather plumbing"
                    )
                deal = deal.miners(self.group.lo, self.group.hi)
            # the statistic gates only the emission of "test"/"count2d";
            # lamp1/count programs are statistic-free, shared under None
            stat_key = statistic if mode in ("test", "count2d") else None
            entry, hit = self._program(mode, dataset.bucket, cfg, stat_key)
            graph = entry.compiled.step_graph
            seen = (graph.replays, graph.graphs)
            with self.tracer.span("dispatch", cache_hit=hit) as dispatch_args:
                start, on_segment = deal, None
                if cfg.ckpt_period > 0:
                    start, on_segment, resumed = self._checkpoints(
                        deal, dataset, cfg, mode=mode, alpha=alpha,
                        delta=delta, statistic=statistic, ctx=ctx, ckpt=ckpt,
                    )
                raw, partial = run_segments(
                    entry.compiled, start, dataset.packed, ctx, cfg=cfg,
                    should_stop=self._should_stop, on_segment=on_segment,
                    tracer=self.tracer,
                )
                if self.group is not None:
                    # every process gathers the same full outputs, so
                    # postprocess (and the ResultSet) is identical everywhere
                    raw = bootstrap.fetch_outputs(raw, self.group)
                if dispatch_args is not None:
                    # the candidate pass's work, from the outputs already
                    # on the host: nodes popped, and the [rows, items]
                    # cells one superstep scans
                    dispatch_args.update(
                        popped=int(raw.stats[:, Stat.POPPED].sum()),
                        supersteps=int(raw.t),
                        rows=self.n_miners * cfg.expand_batch,
                        items=dataset.bucket.items,
                    )
            self._m_replays.inc(graph.replays - seen[0])
            self._m_graphs.inc(graph.graphs - seen[1])
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

    def _checkpoints(self, deal, dataset, cfg, *, mode, alpha, delta,
                     statistic, ctx, ckpt):
        """A segmented pass's checkpoints (DESIGN.md §11): its start, the
        frontier restored from `self._resume_from` (elastically resharded
        onto this session's miner count) where there is one, else `deal`;
        and its `on_segment` writer into a per-phase "<seq>_<mode>" subdir
        of `self._ckpt_dir`, which counts each write in `ckpt` and the
        session's metrics.  Returns (start, on_segment, resumed)."""
        from repro_torch.ckpt import mining as ckpt_mining

        tag = f"{self._phase_seq:02d}_{mode}"
        self._phase_seq += 1
        provenance = ckpt_mining.make_provenance(
            dataset.packed, mode=mode, statistic=statistic, alpha=alpha,
            start_sup=ctx["start_sup"], delta=delta,
        )
        start, resumed = deal, False
        if self._resume_from:
            t0r = time.perf_counter()
            restored = ckpt_mining.restore_frontier(
                os.path.join(self._resume_from, tag), provenance=provenance,
                n_proc=self.n_miners, cfg=cfg, mode=mode,
            )
            self._m_ckpt_restore.observe(time.perf_counter() - t0r)
            if restored is not None:
                start, resumed = restored, True
        if not self._ckpt_dir:
            return start, None, resumed

        def written(path, nbytes, seconds):
            self._m_ckpt_write.observe(seconds)
            self._m_ckpt_bytes.inc(nbytes)
            ckpt["writes"] += 1
            ckpt["bytes"] += nbytes
            ckpt["path"] = path

        return start, ckpt_mining.frontier_writer(
            os.path.join(self._ckpt_dir, tag), provenance=provenance,
            written=written), resumed

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
        0 (a pass of one segment has no boundary to stop at).
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
        self._qid += 1
        try:
            with self.tracer.span(f"query:{type(query).__name__}",
                                  dataset=dataset.name, qid=self._qid):
                report = query.run(self, dataset)
        finally:
            self._stream = None
            self._ckpt_dir = None
            self._resume_from = None
            self._should_stop = None
            self._phase_seq = 0
            self._export_span_drops()
        self._m_query.labels(query=report.query).observe(
            time.perf_counter() - t0
        )
        return report

    def _export_span_drops(self) -> None:
        """Add the tracer's newly overwritten events to
        `miner_spans_dropped_total`."""
        tracer = self.tracer
        seen_tracer, seen = self._span_drops_seen
        dropped = getattr(tracer, "dropped", 0)
        if tracer is not seen_tracer:
            seen = 0
        if dropped > seen:
            self._m_span_drop.inc(dropped - seen)
        self._span_drops_seen = (tracer, dropped)

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
                       statistic: str | None = "fisher", records=None,
                       pvalues=None):
        """Emitted records of one phase output -> ResultSet (results).

        `records=(occ, sup, pos_sup)` overrides the phase output's emitted
        arrays (used to append host-side records, e.g. the root closed set).
        `pvalues`, the records' float64 P-values where the caller has them,
        spares the results layer computing them again.
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
                stream=stream, tracer=self.tracer, pvalues=pvalues,
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

    def _refilter(self, dataset: Dataset, out: MineOutput, statistic: str,
                  delta: float) -> tuple[MineOutput, np.ndarray]:
        """A test pass's superset decided on the host: `out` with only the
        emitted records of float64 P-value <= delta, and `sig_count` the
        host's count (those records and the root, which postprocess tests
        on the host already), with the kept records' P-values.  Records
        lost at out_cap stay counted as the widened gate decided them; the
        ResultSet flags them (`n_dropped`).  The `refilter` span carries
        `emitted`, `kept` and `band`, the records emitted above delta,
        which `miner_gate_band_records_total` adds up, and `distinct`, the
        distinct (support, positive support) pairs among the emitted."""
        n, n_pos = dataset.n_transactions, dataset.n_pos
        with self.tracer.span("refilter") as args:
            emitted = len(out.sig_sup)
            pvalues = get_statistic(statistic).pvalue(out.sig_sup, out.sig_pos_sup,
                                                      n, n_pos)
            keep = pvalues <= delta
            kept = int(keep.sum())
            if args is not None:
                distinct = len(np.unique(out.sig_sup.astype(np.int64) * (n_pos + 1)
                                         + out.sig_pos_sup))
                args.update(emitted=emitted, kept=kept, band=emitted - kept,
                            distinct=distinct)
        if emitted > kept:
            self._m_gate_band.inc(emitted - kept)
        return replace(out, sig_occ=out.sig_occ[keep], sig_core=out.sig_core[keep],
                       sig_sup=out.sig_sup[keep], sig_pos_sup=out.sig_pos_sup[keep],
                       sig_count=out.sig_count - (emitted - kept)), pvalues[keep]

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
    # phase 3: significance testing at delta.  The float32 device test
    # gates at delta * exp(gate_rtol(N)), a superset of the significant
    # records; the host keeps those of float64 P-value <= delta and counts
    # them, so the pass's output holds the records at delta
    ph3 = session.run_phase(dataset, "test", min_sup=min_sup, delta=delta,
                            alpha=alpha, statistic=statistic,
                            band=gate_rtol(dataset.n_transactions))
    out, pvalues = session._refilter(dataset, ph3.output, statistic, delta)
    ph3 = replace(ph3, output=out)
    if ph3.partial:  # records emitted so far are already delta-filtered
        return session._partial_mine_report(
            dataset, [ph1, ph2, ph3], pipeline="three_phase",
            query_tag="significant", alpha=alpha, statistic=statistic, t0=t0,
            min_sup=min_sup, k=k, delta=delta, lam=ph1.lam_final,
        )
    # the root closed set is appended iff the statistic counts it at delta
    # (postprocess's host test, so list and count agree)
    records = session._root_record(dataset, out, statistic, delta, min_sup)
    if records is not None:
        n, n_pos = dataset.n_transactions, dataset.n_pos
        pvalues = np.append(pvalues, get_statistic(statistic).pvalue(n, n_pos, n, n_pos))
    results = session._build_results(
        dataset, out, alpha=alpha, min_sup=min_sup, k=k, delta=delta,
        filter_host=False, statistic=statistic, records=records, pvalues=pvalues,
    )
    return MineReport(
        dataset=dataset.name,
        pipeline="three_phase",
        alpha=alpha,
        lambda_final=ph1.lam_final,
        min_sup=min_sup,
        correction_factor=k,
        delta=delta,
        n_significant=out.sig_count,
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
