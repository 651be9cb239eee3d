"""ResultSet — the materialized output of a significant-pattern mining run.

Counterpart of `repro.results.resultset`, the same code with closure
reconstruction on the port's device.  `build_result_set` turns the emitted
device records into a `ResultSet`:

  closure reconstruction (reconstruct.py, the popcount-GEMM on the card)
  -> dedup by closure -> exact float64 P-values (the registered statistic
  that gated emission) + Bonferroni q-values -> sort by P-value.  With
  statistic=None (closed-frequent queries) patterns stay untested — NaN
  P/q, sorted by support.

Two filtering regimes:

  * mode="test" records were already filtered at delta — on the host in
    float64 for a three_phase query (`MinerSession._refilter`, which hands
    on their P-values), else by the device — pass ``filter_host=False``
    and every record is kept.
  * mode="count2d" records are the alpha-level superset — pass
    ``filter_host=True`` and the host keeps exactly those with exact
    P <= delta.

Streaming (DESIGN.md §10): pass a `ResultStream` and `build_result_set` processes
records in significance order — P-values need only (sup, pos_sup), so they
are computed for every record *before* any closure reconstruction — and
invokes `on_head` with the final top-`head_k` patterns as soon as that head
is provably complete (every unreconstructed record sorts strictly after the
k-th), while the rest of the reconstruction is still running.  Each chunk
is counted on the port's device (on the card: one kernel launch per chunk).
The streamed head equals ``result.patterns[:head_k]`` of the returned
ResultSet, which is itself identical to the non-streaming build.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.core.bitmap import words_to_tensor
from repro_torch.device import resolve_device
from repro_torch.obs.span import NULL_TRACER
from repro_torch.stats import get_statistic

from .reconstruct import dedup_by_closure, reconstruct_closures

__all__ = ["Pattern", "ResultSet", "ResultStream", "build_result_set"]

TSV_COLUMNS = ("rank", "items", "size", "support", "pos_support", "pvalue", "qvalue")


@dataclass(frozen=True)
class ResultStream:
    """Incremental top-k delivery from `build_result_set` (DESIGN.md §10).

    `on_head` is invoked exactly once per build, from the building thread,
    with the final ``patterns[:head_k]`` — as soon as the head is provably
    complete, which is typically long before the full record set has been
    reconstructed (P-values are cheap margin arithmetic; closure
    reconstruction is the popcount-GEMM that dominates).  `chunk` is the
    number of records reconstructed between finality checks.
    """

    head_k: int
    on_head: Callable[[list["Pattern"]], None]
    chunk: int = 256

    def __post_init__(self):
        if not (isinstance(self.head_k, int) and self.head_k >= 1):
            raise ValueError(
                f"ResultStream.head_k must be an int >= 1, got {self.head_k!r}"
            )
        if not (isinstance(self.chunk, int) and self.chunk >= 1):
            raise ValueError(
                f"ResultStream.chunk must be an int >= 1, got {self.chunk!r}"
            )


@dataclass(frozen=True)
class Pattern:
    """One mined closed itemset with its exact test statistics.

    Untested patterns (closed-frequent queries: statistic=None) carry NaN
    P/q-values; exports map them to null.
    """

    items: tuple[int, ...]      # the closure, sorted item ids
    support: int                # x(I): transactions containing the itemset
    pos_support: int            # n(I): positive transactions containing it
    pvalue: float               # exact one-sided P (float64, host); NaN = untested
    qvalue: float               # Bonferroni-adjusted: min(1, P * k); NaN = untested

    def as_dict(self) -> dict:
        return {
            "items": list(self.items),
            "support": int(self.support),
            "pos_support": int(self.pos_support),
            "pvalue": None if math.isnan(self.pvalue) else float(self.pvalue),
            "qvalue": None if math.isnan(self.qvalue) else float(self.qvalue),
        }


@dataclass
class ResultSet:
    """Significant patterns plus the run's testing context, export-ready."""

    patterns: list[Pattern] = field(default_factory=list)  # sorted by pvalue
    n_transactions: int = 0
    n_pos: int = 0
    alpha: float = 0.05
    min_sup: int = 1
    correction_factor: int = 1   # k: number of testable (closed) patterns
    delta: float = 0.05          # alpha / k, the corrected level
    n_dropped: int = 0           # device emissions lost to out_cap saturation
    item_names: tuple[str, ...] | None = None  # column id -> display name
    statistic: str | None = "fisher"  # registered test; None = untested (frequent)
    #: True when the mine stopped at a soft deadline before draining its
    #: frontier (DESIGN.md §11): patterns cover only the explored region
    truncated: bool = False

    @property
    def complete(self) -> bool:
        """False when the pattern list is a subset: out_cap overflowed
        (n_dropped) or the mine stopped early at a soft deadline
        (truncated)."""
        return self.n_dropped == 0 and not self.truncated

    def names_of(self, pattern: Pattern) -> list[str]:
        """Display names of a pattern's items (falls back to the indices)."""
        if self.item_names is None:
            return [str(j) for j in pattern.items]
        return [self.item_names[j] for j in pattern.items]

    def __len__(self) -> int:
        return len(self.patterns)

    def __iter__(self):
        return iter(self.patterns)

    def top(self, k: int | None = None) -> list[Pattern]:
        """The k most significant patterns (all when k is None)."""
        return self.patterns[:k] if k is not None else list(self.patterns)

    def describe(self, top_k: int | None = 10, planted=None) -> str:
        """Human-readable top-k summary — the one formatter the CLI and
        examples share, so pattern-line wording never drifts between them."""
        shown = min(top_k, len(self)) if top_k is not None else len(self)
        kind = "significant" if self.statistic is not None else "closed frequent"
        lines = [
            f"top {shown} of {len(self)} {kind} patterns"
            + ("" if self.complete else "  [INCOMPLETE: "
               + ("partial mine" if self.truncated
                  else f"{self.n_dropped} dropped") + "]")
        ]
        for rank, p in enumerate(self.top(top_k), start=1):
            shown = "[" + ", ".join(self.names_of(p)) + "]"
            line = (f" {rank:3d}  items={shown}  sup={p.support} "
                    f"pos={p.pos_support}")
            if not math.isnan(p.pvalue):
                line += f"  p={p.pvalue:.3e}  q={p.qvalue:.3e}"
            lines.append(line)
        if planted is not None:
            from .scoring import score_planted

            s = score_planted(self, planted)
            lines.append(
                f"planted-signal recovery: {len(s['recovered'])}/{s['n_planted']} "
                f"(recall {s['recall']:.2f}, precision {s['precision']:.2f})"
            )
        return "\n".join(lines)

    # ------------------------------------------------------------- export
    def to_tsv(self, path: str | None = None, top_k: int | None = None) -> str:
        # the `items` column stays raw column indices (machine-readable);
        # a trailing `names` column is appended when the dataset named them
        cols = TSV_COLUMNS + (("names",) if self.item_names else ())
        lines = ["\t".join(cols)]

        def fmt(v):  # untested (NaN) values export as empty cells, not "nan"
            return "" if math.isnan(v) else f"{v:.6e}"

        for rank, p in enumerate(self.top(top_k), start=1):
            row = (
                f"{rank}\t{','.join(map(str, p.items))}\t{len(p.items)}\t"
                f"{p.support}\t{p.pos_support}\t{fmt(p.pvalue)}\t{fmt(p.qvalue)}"
            )
            if self.item_names:
                row += "\t" + ",".join(self.names_of(p))
            lines.append(row)
        text = "\n".join(lines) + "\n"
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    def to_json(self, path: str | None = None, top_k: int | None = None) -> str:
        def pattern_dict(p: Pattern) -> dict:
            d = p.as_dict()   # "items" stays indices — machine-readable
            if self.item_names:
                d["names"] = self.names_of(p)
            return d

        def nan_null(v):  # NaN is not valid JSON; untested runs export null
            return None if isinstance(v, float) and math.isnan(v) else v

        payload = {
            "n_transactions": self.n_transactions,
            "n_pos": self.n_pos,
            "statistic": self.statistic,
            "alpha": nan_null(self.alpha),
            "min_sup": self.min_sup,
            "correction_factor": self.correction_factor,
            "delta": nan_null(self.delta),
            "n_patterns": len(self.patterns),
            "complete": self.complete,
            "n_dropped": self.n_dropped,
            "patterns": [pattern_dict(p) for p in self.top(top_k)],
        }
        text = json.dumps(payload, indent=1)
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    def save(self, path: str, top_k: int | None = None) -> None:
        """Write TSV or JSON by file extension (.tsv/.txt vs .json)."""
        if path.endswith(".json"):
            self.to_json(path, top_k)
        else:
            self.to_tsv(path, top_k)


def build_result_set(
    occ: np.ndarray,
    sup: np.ndarray,
    pos_sup: np.ndarray,
    db_bits: "np.ndarray | torch.Tensor",
    *,
    n: int,
    n_pos: int,
    alpha: float,
    min_sup: int,
    correction_factor: int,
    delta: float,
    filter_host: bool = False,
    dropped: int = 0,
    item_names: tuple[str, ...] | None = None,
    statistic: str | None = "fisher",
    device=None,
    impl: str = "auto",
    stream: ResultStream | None = None,
    tracer=NULL_TRACER,
    pvalues: np.ndarray | None = None,
) -> ResultSet:
    """Emitted records -> deduped, exactly-(re)tested, sorted ResultSet.

    `statistic` names the registered test used for the exact host P-values
    (it must match the device test that emitted the records); None skips
    testing entirely — patterns carry NaN P/q and sort by support (the
    closed-frequent objective).  `db_bits` is the [M, W] database: an int32
    tensor of words is used where it lies (a session passes its dataset's
    resident copy); uint32 numpy words are uploaded to `device` (default:
    the card; pass device="cpu" to run on the CPU).  `impl` picks the
    support count of closure reconstruction ("auto": the kernel on the card).
    `stream` delivers the top-`head_k` head to a callback mid-build (see
    `ResultStream`); the returned ResultSet is identical either way.
    `tracer` records the reconstruction's `closure.*` spans
    (`reconstruct_closures`), `dedup` and `score` (the float64 P/q, the
    patterns and their sort).  `pvalues`, the records' float64 P-values
    where the caller has computed them, are used instead of computing them
    again.
    """
    occ = np.asarray(occ, dtype=np.uint32).reshape(-1, db_bits.shape[1])
    if isinstance(db_bits, torch.Tensor):
        db_dev = db_bits
    else:
        db_dev = words_to_tensor(np.asarray(db_bits), resolve_device(device))
    sup = np.asarray(sup, dtype=np.int64).reshape(-1)
    pos_sup = np.asarray(pos_sup, dtype=np.int64).reshape(-1)
    if pvalues is not None:
        pvalues = np.asarray(pvalues, dtype=np.float64).reshape(-1)

    k = max(int(correction_factor), 1)
    if stream is not None:
        patterns = _build_patterns_streaming(
            occ, sup, pos_sup, db_dev, n=n, n_pos=n_pos, k=k, delta=delta,
            filter_host=filter_host, statistic=statistic, stream=stream,
            impl=impl, tracer=tracer, pvalues=pvalues,
        )
        return ResultSet(
            patterns=patterns,
            n_transactions=n,
            n_pos=n_pos,
            alpha=alpha,
            min_sup=min_sup,
            correction_factor=int(correction_factor),
            delta=delta,
            n_dropped=int(dropped),
            item_names=tuple(item_names) if item_names is not None else None,
            statistic=statistic,
        )

    closures = reconstruct_closures(occ, sup, db_dev, impl=impl, tracer=tracer)
    with tracer.span("dedup"):
        if pvalues is None:
            closures, sup, pos_sup = dedup_by_closure(closures, sup, pos_sup)
        else:
            closures, sup, pos_sup, pvalues = dedup_by_closure(closures, sup, pos_sup,
                                                               pvalues)

    with tracer.span("score"):
        patterns = []
        if len(closures) and statistic is None:
            for i in range(len(closures)):
                patterns.append(Pattern(
                    items=closures[i],
                    support=int(sup[i]),
                    pos_support=int(pos_sup[i]),
                    pvalue=float("nan"),
                    qvalue=float("nan"),
                ))
        elif len(closures):
            pvals = (get_statistic(statistic).pvalue(sup, pos_sup, n, n_pos)
                     if pvalues is None else pvalues)
            keep = pvals <= delta if filter_host else np.ones(len(closures), bool)
            for i in np.flatnonzero(keep):
                p = float(pvals[i])
                patterns.append(Pattern(
                    items=closures[i],
                    support=int(sup[i]),
                    pos_support=int(pos_sup[i]),
                    pvalue=p,
                    qvalue=min(1.0, p * k),
                ))

        # The root closed set (closure of the empty itemset) never rides
        # the device buffers, so it only appears here if the caller
        # appended its record to the inputs.  Under Fisher it never
        # qualifies (its one-sided P-value is exactly 1 and delta = alpha/k
        # < 1 always).

        patterns.sort(key=_sort_key(statistic))
    return ResultSet(
        patterns=patterns,
        n_transactions=n,
        n_pos=n_pos,
        alpha=alpha,
        min_sup=min_sup,
        correction_factor=int(correction_factor),
        delta=delta,
        n_dropped=int(dropped),
        item_names=tuple(item_names) if item_names is not None else None,
        statistic=statistic,
    )


def _sort_key(statistic: str | None):
    """The one canonical pattern ordering (streaming finality depends on it:
    the partial key (pvalue, -support) must be a prefix of this full key)."""
    if statistic is None:
        return lambda p: (-p.support, p.items)
    return lambda p: (p.pvalue, -p.support, p.items)


def _build_patterns_streaming(
    occ, sup, pos_sup, db_dev, *, n, n_pos, k, delta, filter_host,
    statistic, stream: ResultStream, impl: str, tracer, pvalues=None,
) -> list[Pattern]:
    """Reconstruct records in significance order, stream the head early.

    P-values depend only on the margins (sup, pos_sup, n, n_pos), so every
    record is tested *before* any reconstruction; records are then
    reconstructed most-significant-first in `stream.chunk` batches.  Two
    records with the same closure are exact duplicates (the closure fixes
    occ, hence sup/pos_sup/P), so incremental dedup keeps content identical
    to the batch path's first-in-emission-order dedup.  The head is final
    once the next unreconstructed record's (pvalue, -support) key sorts
    strictly after the current k-th pattern's — the items tie-break can
    only reorder *within* an equal (pvalue, -support) class.
    """
    n_rec = len(sup)
    full_key = _sort_key(statistic)
    with tracer.span("score"):
        if statistic is None:
            pvals = None
            idx = np.arange(n_rec)
            order = idx[np.lexsort((idx, -sup))] if n_rec else idx
            partial = lambda j: (-int(sup[j]),)                    # noqa: E731
            partial_p = lambda p: (-p.support,)                    # noqa: E731
        else:
            pvals = (pvalues if pvalues is not None
                     else get_statistic(statistic).pvalue(sup, pos_sup, n, n_pos)
                     if n_rec else np.zeros(0))
            idx = np.flatnonzero(pvals <= delta) if filter_host else np.arange(n_rec)
            order = (idx[np.lexsort((idx, -sup[idx], pvals[idx]))]
                     if len(idx) else idx)
            partial = lambda j: (float(pvals[j]), -int(sup[j]))    # noqa: E731
            partial_p = lambda p: (p.pvalue, -p.support)           # noqa: E731

    seen: set[tuple[int, ...]] = set()
    patterns: list[Pattern] = []
    head_sent = False
    for lo in range(0, max(len(order), 1), stream.chunk):
        sel = order[lo:lo + stream.chunk]
        # occ[sel] is a gather, so the chunk is a fresh array: its upload
        # starts on an allocation's 16-byte boundary, as the kernel needs
        closures = reconstruct_closures(occ[sel], sup[sel], db_dev, impl=impl,
                                        tracer=tracer)
        with tracer.span("dedup"):
            for j, c in zip(sel, closures):
                if c in seen:
                    continue
                seen.add(c)
                if pvals is None:
                    p = q = float("nan")
                else:
                    p = float(pvals[j])
                    q = min(1.0, p * k)
                patterns.append(Pattern(
                    items=c, support=int(sup[j]), pos_support=int(pos_sup[j]),
                    pvalue=p, qvalue=q,
                ))
        if head_sent:
            continue
        with tracer.span("score"):
            patterns.sort(key=full_key)
            nxt = lo + stream.chunk
            if nxt >= len(order):
                head_sent = True   # everything reconstructed: the head is final
            elif (len(patterns) >= stream.head_k
                  and partial(order[nxt]) > partial_p(patterns[stream.head_k - 1])):
                head_sent = True
        if head_sent:
            stream.on_head(patterns[: stream.head_k])
    with tracer.span("score"):
        patterns.sort(key=full_key)
    return patterns
