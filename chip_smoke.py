#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` (PATH or /usr/local/cuda/bin) and the checkout's
`src/`; it exits non-zero without them.  Phases, each of which fails the
run on any error (each prints its wall time):

1. environment: the card's name and power limit (nvidia-smi);
2. build: compile the support-count CUDA kernel for sm_90a from the
   checkout's source (into build/repro_torch/);
3. kernel vs plain: the kernel must equal the plain PyTorch version bit for
   bit at the engine's shapes (exact and as the session's shape buckets pad
   them; mcf7's LAMP query at 512 words among them), the reconstruction's
   and ragged shapes, crossing every fragment
   and tile edge of the MMA kernel; each shape is timed beside its bound
   and beside one PyTorch matmul on operands unpacked to {0, 1}
   beforehand (`torch._int_mm` where B > 16, else a float16 or float32
   `torch.mm`: the library yardstick, which the port never calls);
4. the session API (`repro_torch.api`) on hapmap_dom_20 at 1,191 items,
   P = 8 miners, the Dataset packed once per device:
   (a) `fused23` with Fisher's test, cold then warm (the warm run builds no
       program, and its kernel launches are the main path's count),
   (b) `three_phase`, Fisher, (c) `fused23` with chi2 — each of (a)-(c)
       with the kernel and with the plain version on the card, and (a) on
       the CPU too, all identical — and (d) the top-10 query with the
       kernel; every query's values equal the JAX package's;
5. the paper's full widths: mode `count` on hapmap_dom_20 (11,914 items)
   and alz_rec_30 (250,120 items), kernel against plain version, then once
   more under the profiler; and the closed-frequent query through the
   session on both, kernel against plain version, equal to the JAX
   package's patterns;
6. the superstep trace ring and fault tolerance, each run launching the
   kernel in every phase: (a) query (a) traced equals untraced, its trace
   digest and a wrapped ring's trace_dropped equal the JAX package's; (b)
   query (a) in segments of 8, killed by an injected fault, resumed on 8, 4
   and 1 miners; (c) a soft stop after one segment gives a partial report,
   whose checkpoint resumes to (a)'s answer; (d) the full-width
   hapmap_dom_20 Fisher query, one segment of k supersteps at a time: its
   frontiers at k and 2k equal the JAX package's; (e) the alz_rec_30
   closed-frequent query checkpointed every superstep, killed and resumed
   on 4 miners; (f) the CLI with --trace-period and --ckpt-period, its
   artifacts validated; (g) the warm wall of (a) classic, segmented,
   segmented with checkpoints and traced, three rounds, with checkpoint
   write times and bytes and the peak device memory of each query;
7. serving (`repro_torch.serve`) at phase 4's bucket, P = 8 per session:
   (a) query (a) streamed on the warm session, its head (top 10) delivered
   once, equal to the final top 10, the report equal to (a)'s; (b) a
   `MiningService` of 1, 2 and 4 sessions on the card, one CUDA stream
   each, warmed before traffic, draining 16 reseeded requests closed-loop
   at a concurrency of the fleet size: every served report equals a direct
   warm run of the same request, the kernel launches summed over the fleet
   equal the direct runs', no request compiles; qps, latency percentiles
   and the device's idle share while every worker serves; (c) a request retried to success after an
   injected failure, and one whose deadline stops it mid-mine ("partial"),
   whose checkpoint resumes to (a)'s answer; (d) the `mine_serve` CLI;
8. topology (`repro_torch.topo`): (a) query (a) warm at forced 2x4 and
   4x2 (the hierarchical lifeline schedule over the same 8 miners), each
   equal to the JAX package's forced run (supersteps, per-miner stats,
   steal volume by named round) and to flat (a)'s ResultSet, with its
   wall and launches (and 2x4's idle share); (b) a gloo cluster of 2 processes x 4
   miners on the one card (`bootstrap.launch_local_cluster`), each process
   equal to (a)'s 2x4 run and launching the kernel at B = 16 x 4;
9. the kernel's tile (9a-9d, see `phase9`);
10. each superstep one CUDA graph replay (`phase10`): mcf7's LAMP query
   and alz_rec_30's closed-frequent query at their widths, P = 8, graph
   against eager bit for bit (reports and launches), the replay share,
   the graph pools' bytes, and the profiler's support-count kernels
   against the launches counted; and alz_rec_30's served by a fleet of
   two under the profiler, its workers running eagerly (10c);
and, after them, the kernel against the plain version at every shape
phases 4-10 launched that phase 3 did not check (3b).

The second-to-last line is a JSON object with the kernel's numbers (its
tile instantiations and phase 9b's per-tile times among them); the last is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks used by the bound (NVIDIA's data sheet, dense): 3.35 TB/s
#: of HBM3, and 1,979 TOP/s int8 on the tensor cores.  The kernel's
#: AND+popcount runs as binary MMA, whose rate is not published; the int8
#: rate stands in for it, counting each bit as one int8 multiply-add.  With
#: it the bytes term is the larger at every main-path shape.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15

#: phase 4's queries on hapmap_dom_20 at 1,191 items: (pipeline or "topk",
#: statistic) and the JAX package's values, which are P-independent
#: (tests/test_torch_slice.py re-derives them from JAX); results_sha256 is
#: the first 16 hex digits of the SHA-256 of `ResultSet.to_json()`, so it
#: pins every pattern and its float64 P- and q-value
QUERY_EXPECT = {
    "a": (("fused23", "fisher"), dict(
        lambda_final=8, min_sup=7, correction_factor=5140, n_significant=623,
        patterns=623, results_sha256="7307b10193e412a9")),
    "b": (("three_phase", "fisher"), dict(
        lambda_final=8, min_sup=7, correction_factor=5140, n_significant=623,
        patterns=623, results_sha256="7307b10193e412a9")),
    "c": (("fused23", "chi2"), dict(
        lambda_final=6, min_sup=5, correction_factor=7854, n_significant=858,
        patterns=858, results_sha256="0b11c151a1ce56f5")),
    "d": (("topk", "fisher"), dict(
        lambda_final=0, min_sup=1, correction_factor=1, n_significant=10,
        patterns=10, delta=9.313991773413716e-33,
        results_sha256="64adb364aa5143f9")),
}
#: top-k query (d)'s k
TOPK = 10
#: the paper's full widths: (problem, min_sup, closed sets, results_sha256
#: of the closed-frequent query), from the JAX package
#: (tests/test_torch_slice.py)
FULL_WIDTH = (("hapmap_dom_20", 625, 204, "8df55e0bdbccbfc5"),
              ("alz_rec_30", 347, 295, "3f2aa2ce5df4614b"))

#: phase 6a: query (a) at P = 8, traced every superstep: the digest of its
#: two phases' decoded traces (`trace_digest`), and each phase's
#: trace_dropped with a ring of `wrap_cap` slots (tests/test_torch_slice.py
#: derives both from the JAX package on eight devices)
TRACE_EXPECT = dict(digest="14bc53989c293a99", wrap_cap=64, wrap_dropped=[61, 40])
#: phase 6d: the hapmap_dom_20 Fisher query at full width (11,914 x 697),
#: P = 8, in segments of k supersteps: the frontier digest
#: (`frontier_digest`) of its lamp1 phase at steps k and 2k, from the JAX
#: package's uninterrupted run on eight devices (tests/test_torch_slice.py)
FRONTIER_EXPECT = dict(problem="hapmap_dom_20", k=128, steps={
    "00_lamp1/step_128": "95b122908f26e5ce",
    "00_lamp1/step_256": "fee30ccf5d4ec112"})
#: phase 8a: query (a) at forced topologies (P = 8, hierarchical lifeline
#: schedule), traced every superstep: each phase's supersteps, the digest
#: of its per-miner stats (`stats_digest`) and the nodes donated in each
#: named steal round, from the JAX package's forced runs on eight devices
#: (tests/test_torch_topo.py); the ResultSet is query (a)'s
TOPO_EXPECT = {
    "2x4": dict(shape=[2, 4], supersteps=[124, 103],
                stats_sha256=["e443757d3fba1085", "48c143a3d9c93ac8"],
                donated_by_round=[
                    {"loc_rand0": 244, "x_rand0": 354, "loc_hc0": 354, "x_hc0": 228,
                     "loc_rand1": 90, "loc_hc1": 53, "loc_rand2": 229,
                     "loc_rand3": 626},
                    {"loc_rand0": 354, "x_rand0": 193, "loc_hc0": 166, "x_hc0": 803,
                     "loc_rand1": 443, "loc_hc1": 16, "loc_rand2": 263,
                     "loc_rand3": 388}]),
    "4x2": dict(shape=[4, 2], supersteps=[133, 105],
                stats_sha256=["b901367ce93b9e05", "56a992176e36900c"],
                donated_by_round=[
                    {"loc_rand0": 252, "x_rand0": 252, "loc_hc0": 235, "x_hc0": 304,
                     "loc_rand1": 187, "x_rand1": 317, "loc_rand2": 235,
                     "x_hc1": 711, "loc_rand3": 53},
                    {"loc_rand0": 177, "x_rand0": 642, "loc_hc0": 370, "x_hc0": 289,
                     "loc_rand1": 105, "x_rand1": 176, "loc_rand2": 200,
                     "x_hc1": 374, "loc_rand3": 20}]),
}
#: phase 8b: a gloo cluster of this many processes x miners each on the
#: one card, running query (a) under the hierarchical schedule of the same
#: shape (so it equals 8a's 2x4 run)
CLUSTER = (2, 4)
#: a SuperstepTrace's arrays, in the order `trace_digest` hashes them
TRACE_ARRAYS = ("steps", "lam", "n_hungry", "fired", "depth", "popped",
                "pushed", "closed", "emitted", "donated", "received")
#: phase 7b: the requests each fleet drains — datasets reseeded 0..15 in
#: (a)'s bucket (seed 0 is (a)'s), alpha cycling, `fused23` with Fisher's
#: test — and the fleet sizes, each drained at a concurrency of its size
SERVE_REQUESTS = 16
SERVE_ALPHAS = (0.05, 0.01)
SERVE_FLEETS = (1, 2, 4)
#: the kernel's template instantiations, (block_m, block_w)
INSTANTIATIONS = [(32, 32), (32, 64), (64, 32), (64, 64), (128, 32), (128, 64)]
#: phase 9a: every candidate tile against the plain version at each shape
#: of this cross product (W = 65 and 96 run the chunked plan under both
#: block_w)
TILE_B = (1, 17, 111, 512, 1024)
TILE_M = (1191, 2048, 11914, 11916, 253952)
TILE_W = (12, 22, 32, 65, 96)
#: phase 9b: the main path's shapes, every candidate timed: EXPAND at
#: 1,191 items (P = 8, and 4 per process of 8b), a reconstruction chunk,
#: EXPAND at both full widths, alz_rec_30's reconstruction, EXPAND of
#: mcf7's LAMP query
TILE_SHAPES = ((128, 2048, 32), (64, 2048, 32), (512, 2048, 32),
               (128, 16384, 32), (128, 262144, 16), (295, 262144, 16),
               (1024, 512, 512))
#: phase 9c: query (a) with this tile pinned (the default at its EXPAND
#: shape, (128, 2048, 32), is (16, 64, 32))
PINNED_TILE = (32, 128, 32)
#: phase 10: the benchmark's two deployments at their widths, P = 8:
#: (problem, expand batch, query) — mcf7's LAMP query (three_phase,
#: Fisher) and alz_rec_30's closed-frequent query
GRAPH_CELLS = (("mcf7", 128, ("lamp", 0.05)), ("alz_rec_30", 16, ("closed", 347)))
#: the idle share's profile: (s after a pass starts, s of window).  The
#: pass serves requests 1..size, one per worker, each longer than the
#: window's end even alone (request 1 is the longest of the 16)
IDLE_WINDOW = (0.2, 0.6)

def make_query(tag: str):
    """Phase 4's query object for `tag` (a key of QUERY_EXPECT)."""
    from repro_torch.api import SignificantPatternQuery, TopKSignificantQuery

    (pipeline, statistic), _ = QUERY_EXPECT[tag]
    if pipeline == "topk":
        return TopKSignificantQuery(k=TOPK, statistic=statistic)
    return SignificantPatternQuery(pipeline=pipeline, statistic=statistic)


def results_sha256(results) -> str:
    return hashlib.sha256(results.to_json().encode()).hexdigest()[:16]


def query_values(report) -> dict:
    """The values of a MineReport that QUERY_EXPECT / FULL_WIDTH pin."""
    return dict(lambda_final=report.lambda_final, min_sup=report.min_sup,
                correction_factor=report.correction_factor,
                n_significant=report.n_significant, patterns=len(report.results),
                delta=report.delta, results_sha256=results_sha256(report.results))


def expect_diffs(report, expect: dict) -> list[str]:
    got = query_values(report)
    return [f"{k}={got[k]!r} (expected {v!r})" for k, v in expect.items()
            if got[k] != v]


def mine_output_diffs(a, b) -> list[str]:
    """Names of the MineOutput fields in which two passes differ."""
    bad = []
    for f in ("lam_final", "supersteps", "sig_count", "emit_dropped"):
        if getattr(a, f) != getattr(b, f):
            bad.append(f)
    for f in ("hist", "hist2d", "sig_occ", "sig_core", "sig_sup", "sig_pos_sup"):
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None) or (x is not None and not np.array_equal(x, y)):
            bad.append(f)
    for name in a.stats:
        if not np.array_equal(a.stats[name], b.stats[name]):
            bad.append(f"stats.{name}")
    return bad


def _same(x, y) -> bool:
    return x == y or (isinstance(x, float) and isinstance(y, float)
                      and math.isnan(x) and math.isnan(y))


#: PhaseReport fields that must agree between runs (walls, build times,
#: cache hits and the resolved kernel differ by design)
PHASE_FIELDS = ("mode", "supersteps", "lam_final", "n_nodes", "steals",
                "steal_rounds", "emit_dropped", "item_tile", "n_item_tiles")
REPORT_FIELDS = ("dataset", "pipeline", "alpha", "lambda_final", "min_sup",
                 "correction_factor", "delta", "n_significant", "statistic",
                 "query", "partial", "ckpt_path")


def report_diffs(a, b) -> list[str]:
    """Fields in which two MineReports differ: every report field but the
    wall time, every phase's fields and raw output, and the ResultSet by
    its exports (which carry each float64 P/q-value exactly)."""
    bad = [f for f in REPORT_FIELDS if not _same(getattr(a, f), getattr(b, f))]
    if len(a.phases) != len(b.phases):
        bad.append("len(phases)")
    for i, (x, y) in enumerate(zip(a.phases, b.phases)):
        bad += [f"phase{i + 1}.{f}" for f in PHASE_FIELDS
                if getattr(x, f) != getattr(y, f)]
        bad += [f"phase{i + 1}.{f}" for f in mine_output_diffs(x.output, y.output)]
    ra, rb = a.results, b.results
    if (ra.complete, ra.truncated) != (rb.complete, rb.truncated):
        bad.append("results.complete")
    if ra.to_tsv() != rb.to_tsv() or ra.to_json() != rb.to_json():
        bad.append("results.export")
    return bad


def trace_digest(traces) -> str:
    """First 16 hex digits of the SHA-256 of decoded traces' arrays (int32,
    TRACE_ARRAYS order, trace after trace)."""
    h = hashlib.sha256()
    for tr in traces:
        for f in TRACE_ARRAYS:
            h.update(np.ascontiguousarray(getattr(tr, f), np.int32).tobytes())
    return h.hexdigest()[:16]


def stats_digest(stats: dict) -> str:
    """First 16 hex digits of the SHA-256 of a phase's per-miner stats
    ({name: [P] counts}) as sorted JSON."""
    rows = {k: [int(x) for x in np.asarray(v).tolist()] for k, v in stats.items()}
    return hashlib.sha256(json.dumps(rows, sort_keys=True).encode()).hexdigest()[:16]


def frontier_digest(carry: dict, fields) -> str:
    """First 16 hex digits of the SHA-256 of a host carry's leaves, in
    `fields` order."""
    h = hashlib.sha256()
    for k in fields:
        h.update(np.ascontiguousarray(carry[k]).tobytes())
    return h.hexdigest()[:16]


def step_digests(ckpt_dir: str, load_frontier, fields) -> dict:
    """{"<phase>/step_<N>": frontier digest} of every step under a query's
    checkpoint directory."""
    out = {}
    for phase in sorted(os.listdir(ckpt_dir)):
        pdir = os.path.join(ckpt_dir, phase)
        for name in sorted(os.listdir(pdir)):
            if name.startswith("step_"):
                carry, _ = load_frontier(pdir, int(name[5:]))
                out[f"{phase}/{name}"] = frontier_digest(carry, fields)
    return out


def _metric(session, name: str) -> float:
    """One unlabelled sample of the session's Prometheus exposition."""
    for line in session.metrics.expose_text().splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return 0.0


def _nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_times(prof) -> dict[str, tuple[int, float]]:
    """{kernel name: (launches, device us)} of the CUDA activity a
    torch.profiler run recorded ({} when it saw no device time).  The
    device-side ranges of host annotations (`record_function` spans) are
    not activity of their own and are left out."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            out[e.key] = (e.count, float(us))
    return out


def _profile(fn):
    """(result, {kernel: (launches, device us)}, profiled wall s) of fn()."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out, wall = _wall(fn)
    return out, _device_times(prof), wall


def _device_ms(fn, kernel: str | None = None, iters: int = 20):
    """Device time of one call of fn: all the CUDA activity the profiler
    saw over `iters` calls, over `iters`; None when the profile recorded
    fewer launches than were made (of `kernel`, by name, or else fewer
    device activities than calls)."""
    import torch

    torch.cuda.synchronize()
    _, dev, _ = _profile(lambda: [fn() for _ in range(iters)])
    seen = sum(n for k, (n, _) in dev.items() if kernel is None or kernel in k)
    if seen == iters if kernel is not None else seen >= iters:
        return sum(us for _, us in dev.values()) / iters / 1e3
    print(f"    (the profiler saw {seen} of {iters} launches: not measured)",
          flush=True)
    return None


def _bound(b: int, m: int, w: int):
    """(bound_ms, bound_by): bytes over HBM vs bit operations over the
    int8 tensor rate (each input read once, S written once)."""
    ops_s = 2 * b * m * 32 * w / INT8_OPS_PER_S
    bytes_s = (m * w + b * w + b * m) * 4 / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s > bytes_s else "bytes")


def _library(occ, db):
    """(call, m_pad, name): one PyTorch matmul over `occ` and the database
    unpacked to {0, 1} beforehand — `torch._int_mm` in int8 with M padded by
    zero items to a multiple of 8, as that call requires on CUDA, where
    B > 16 (its other limit); below that a float16 `torch.mm` where every
    count, at most 32 W <= 2,048, is exact in float16, else float32.  The
    yardstick only; the port never counts this way."""
    import torch

    from repro_torch.kernels.support_count.ref import unpack_bits_int8

    b, m = occ.shape[0], db.shape[0]
    if b > 16:
        m_pad = -(-m // 8) * 8
        occ_u8 = unpack_bits_int8(occ)
        db_u8 = torch.zeros((m_pad, occ_u8.shape[1]), dtype=torch.int8,
                            device=db.device)
        db_u8[:m] = unpack_bits_int8(db)
        return (lambda: torch._int_mm(occ_u8, db_u8.t())), m_pad, "_int_mm"
    dtype = torch.float16 if 32 * occ.shape[1] <= 2048 else torch.float32
    occ_f = unpack_bits_int8(occ).to(dtype)
    db_f = unpack_bits_int8(db).to(dtype)
    return (lambda: torch.mm(occ_f, db_f.t())), m, f"mm/{str(dtype)[6:]}"


def check_kernel(shapes, profiled: int = 0) -> list[dict]:
    """Phase 3: the kernel against the plain version at each (B, M, W).

    `ms`/`plain_ms`/`library_call_ms` are CUDA-event times per call over
    back-to-back calls; for the first `profiled` shapes `device_ms` and
    `library_ms` are the device time per call from the profiler
    (back-to-back calls of a small kernel measure the host's launch rate,
    not the kernel).  The share of the bound is taken against the device
    time where there is one."""
    import torch

    from repro_torch.kernels.support_count import kernel
    from repro_torch.kernels.support_count.ref import support_count_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for i, (b, m, w) in enumerate(shapes):
        occ = torch.randint(-2**31, 2**31, (b, w), dtype=torch.int32,
                            device="cuda", generator=gen)
        db = torch.randint(-2**31, 2**31, (m, w), dtype=torch.int32,
                           device="cuda", generator=gen)
        occ[0] = -1                     # all-ones words (high bit set)
        db[m // 2] = -1
        got = kernel.support_count_cuda(occ, db)
        want = support_count_ref(occ, db)
        torch.cuda.synchronize()
        diff = (got.long() - want.long()).abs()
        mismatches = int((diff != 0).sum())
        max_err = int(diff.max()) if diff.numel() else 0
        big = b * m * w > 1 << 22
        prof = i < profiled
        ms = _time_ms(lambda: kernel.support_count_cuda(occ, db), 20 if big else 100)
        plain_ms = _time_ms(lambda: support_count_ref(occ, db), 3 if big else 10, 1)
        device_ms = (_device_ms(lambda: kernel.support_count_cuda(occ, db),
                                "support_count_kernel") if prof else None)
        lib, m_pad, lib_name = _library(occ, db)
        if not torch.equal(lib()[:, :m].to(torch.int32), want):
            raise AssertionError(f"library {lib_name} != plain version at {(b, m, w)}")
        lib_call_ms = _time_ms(lib, 20 if big else 100)
        library_ms = _device_ms(lib) if prof else None
        del lib
        bound_ms, bound_by = _bound(b, m, w)
        share = bound_ms / (device_ms if device_ms is not None else ms)
        row = dict(shape=[b, m, w], mismatches=mismatches, max_abs_err=max_err,
                   ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                   library_ms=library_ms, library_call_ms=lib_call_ms,
                   library=lib_name, library_m_pad=m_pad, bound_ms=bound_ms,
                   bound_by=bound_by,
                   share_of_bound=share)
        rows.append(row)
        dev_txt = "" if device_ms is None else f" (device {device_ms:.4f})"
        lib_txt = (f"  library {lib_name} {lib_call_ms:.4f}"
                   + ("" if library_ms is None else f" (device {library_ms:.4f})")
                   + ("" if m_pad == m else f" [M padded to {m_pad}]"))
        print(f"  kernel {b:>4} x {m:>6} x {w:>3}: mismatches {mismatches} "
              f"max_abs_err {max_err}  kernel {ms:.4f}{dev_txt}  plain "
              f"{plain_ms:.4f}{lib_txt}  bound {bound_ms:.5f} ({bound_by}) "
              f"share {100 * share:.1f}%  [ms]", flush=True)
        if mismatches:
            raise AssertionError(f"kernel != plain version at {(b, m, w)}")
    return rows


def check_kernel_in_child(shapes) -> list[dict]:
    """`check_kernel(shapes)`, all profiled, in a fresh process of this
    script.  Late in a run, after phase 4's long profile, the profiler was
    seen to record 3 of 20 launches per session, so these shapes are
    profiled in a process whose profiler has not run yet, as phase 3's
    are.  The child's lines are echoed; its last line holds the rows.  A
    kernel error in the child fails the run."""
    if not shapes:
        return []
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--check-shapes",
         json.dumps([list(s) for s in shapes])],
        capture_output=True, text=True, timeout=900,
    )
    lines = proc.stdout.rstrip("\n").splitlines()
    print("\n".join(lines[:-1]), flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"3b child failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1])


def _wall(fn):
    import torch

    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _counted(fn):
    """(result, wall s, kernel launches, launches by (B, M, W)) of fn(),
    the kernel's counters set to 0 just before it."""
    from repro_torch.kernels.support_count import kernel

    kernel.reset_counts()
    out, wall = _wall(fn)
    return out, wall, kernel.launches, dict(kernel.launch_shapes)


def _profile_line(tag: str, dev: dict, wall: float, wall_p: float,
                  steps: int | None = None) -> None:
    """Device busy/idle share of an unprofiled wall, from a profiled rerun."""
    if not dev:
        print(f"  profile of {tag}: the profiler saw no device time "
              "(not measured)", flush=True)
        return
    busy = sum(us for _, us in dev.values()) / 1e6
    n_kern = sum(n for n, _ in dev.values())
    sc = sum(us for k, (_, us) in dev.items() if "support_count_kernel" in k) / 1e6
    per = "" if steps is None else f" ({n_kern / steps:.1f} per superstep)"
    print(f"  profile of {tag}: device busy {busy * 1e3:.3f} ms = "
          f"{100 * busy / wall:.2f}% of the unprofiled {wall:.3f} s "
          f"(idle {100 * (1 - busy / wall):.2f}%); {n_kern} device "
          f"activities{per}; support_count {sc * 1e3:.3f} ms = "
          f"{100 * sc / busy:.2f}% of device time; profiled wall "
          f"{wall_p:.3f} s", flush=True)


def phase6(ds_a, rep_a, launched: set) -> dict:
    """Phase 6: the trace ring and fault tolerance on the card (6a-6g).

    `ds_a` is phase 4's 1,191-item Dataset on the card, `rep_a` query (a)'s
    untraced, unsegmented warm report there.  Every run adds its kernel
    launch shapes to `launched` (3b checks them) and must launch the CUDA
    kernel in every phase.  Checkpoints go under build/chip_smoke/, removed
    at the end.  Returns {run: kernel launches}.
    """
    import torch

    from repro_torch.api import (
        ClosedFrequentQuery,
        Dataset,
        MinerSession,
        RuntimeConfig,
        SignificantPatternQuery,
    )
    from repro_torch.ckpt.mining import load_frontier
    from repro_torch.core.engine import CARRY_FIELDS
    from repro_torch.data.synthetic import paper_problem_packed
    from repro_torch.testing import FaultPlan, SimulatedFault, injected

    tmp = ROOT / "build" / "chip_smoke"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    q_a = make_query("a")
    sha_a = QUERY_EXPECT["a"][1]["results_sha256"]
    launches: dict[str, int] = {}

    def run(tag, session, ds, query, **kw):
        """(report, wall s, peak MiB): the kernel's counters and the peak
        memory counter reset just before."""
        torch.cuda.reset_peak_memory_stats()
        rep, wall, n, shapes = _counted(lambda: session.run(ds, query, **kw))
        peak = torch.cuda.max_memory_allocated() / 2**20
        launched.update(shapes)
        launches[tag] = n
        if n <= 0 or any(p.kernel_impl != "cuda" for p in rep.phases):
            raise AssertionError(f"(6) {tag}: {n} kernel launches, impls "
                                 f"{[p.kernel_impl for p in rep.phases]}")
        print(f"  {tag}: {wall:.3f} s, supersteps "
              f"{'+'.join(str(p.supersteps) for p in rep.phases)}, kernel launches "
              f"{n}, peak {peak:.1f} MiB, ckpt writes "
              f"{sum(p.ckpt_writes for p in rep.phases)}, partial {rep.partial}, "
              f"resumed {[p.mode for p in rep.phases if p.resumed]}", flush=True)
        return rep, wall, peak

    def killed(session, ds, query, plan, **kw):
        try:
            with injected(plan):
                session.run(ds, query, **kw)
        except SimulatedFault as e:
            print(f"  injected kill: {e}", flush=True)
            return
        raise AssertionError("the injected fault never fired")

    def check_sha(tag, rep, sha):
        got = results_sha256(rep.results)
        if got != sha or not rep.results.complete or rep.partial:
            raise AssertionError(f"(6) {tag}: results_sha256 {got}, complete "
                                 f"{rep.results.complete}; expected {sha}")

    def ckpt_line(tag, session):
        n = _metric(session, "miner_ckpt_write_seconds_count")
        s = _metric(session, "miner_ckpt_write_seconds_sum")
        b = _metric(session, "miner_ckpt_bytes_total")
        print(f"  {tag} checkpoints: {n:.0f} writes, {s / max(n, 1) * 1e3:.3f} ms "
              f"and {b / max(n, 1) / 2**20:.3f} MiB per segment "
              f"({b / max(s, 1e-9) / 2**30:.3f} GiB/s)", flush=True)

    try:
        # (6a) the trace ring: changes nothing, equals the JAX package's
        print("[6a] query (a) traced every superstep, P = 8", flush=True)
        traced = MinerSession(8, runtime=RuntimeConfig(trace_period=1, trace_cap=256))
        rep_t = run("6a traced", traced, ds_a, q_a)[0]
        bad = report_diffs(rep_a, rep_t)
        if bad:
            raise AssertionError(f"(6a) traced (a) != untraced in {bad}")
        digest = trace_digest([p.trace for p in rep_t.phases])
        if digest != TRACE_EXPECT["digest"]:
            raise AssertionError(f"(6a) trace digest {digest}, expected the JAX "
                                 f"package's {TRACE_EXPECT['digest']}")
        wrap = MinerSession(8, runtime=RuntimeConfig(
            trace_period=1, trace_cap=TRACE_EXPECT["wrap_cap"]))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rep_w = run("6a wrapped", wrap, ds_a, q_a)[0]
        dropped = [p.trace_dropped for p in rep_w.phases]
        # the ring's own counter is the one field a wrap may change
        bad = [d for d in report_diffs(rep_a, rep_w)
               if not d.endswith(".stats.trace_dropped")]
        warned = any("trace ring wrapped" in str(w.message) for w in caught)
        if dropped != TRACE_EXPECT["wrap_dropped"] or bad or not warned:
            raise AssertionError(
                f"(6a) wrapped ring: trace_dropped {dropped} (expected "
                f"{TRACE_EXPECT['wrap_dropped']}), differs from (a) in {bad}, "
                f"warned {warned}")
        print(f"  (6a) traced == untraced; trace digest {digest} and wrapped "
              f"trace_dropped {dropped} equal the JAX package's; "
              f"{rep_t.phases[1].trace.summary()}", flush=True)

        # (6b) killed a few segments in, resumed on 8, 4 and 1 miners
        print("[6b] query (a), ckpt_period 8: kill, then elastic resume", flush=True)
        seg = RuntimeConfig(ckpt_period=8)
        d_b = str(tmp / "6b")
        killed(MinerSession(8, runtime=seg), ds_a, q_a,
               FaultPlan(die_after_segments=5), ckpt_dir=d_b)
        for p in (8, 4, 1):
            rep = run(f"6b resume on {p}", MinerSession(p, runtime=seg), ds_a, q_a,
                      resume_from=d_b)[0]
            if not rep.phases[0].resumed:
                raise AssertionError(f"(6b) the resume on {p} restored nothing")
            check_sha(f"6b resume on {p}", rep, sha_a)

        # (6c) a soft deadline after the first segment, then its resume
        print("[6c] query (a): soft stop after one segment, then resume", flush=True)
        d_c = str(tmp / "6c")
        part = run("6c partial", MinerSession(8, runtime=seg), ds_a, q_a,
                   ckpt_dir=d_c, should_stop=lambda: True)[0]
        if not part.partial or part.results.complete or not part.ckpt_path:
            raise AssertionError(f"(6c) not a partial report: {part.summary()}")
        resume_dir = os.path.dirname(os.path.dirname(part.ckpt_path))
        check_sha("6c resumed", run("6c resumed", MinerSession(8, runtime=seg), ds_a,
                                    q_a, resume_from=resume_dir)[0], sha_a)

        # (6d) the full-width hapmap_dom_20 Fisher query, one segment at a time
        k = FRONTIER_EXPECT["k"]
        name = FRONTIER_EXPECT["problem"]
        bits, lab, _, sp = paper_problem_packed(name)
        ds_f = Dataset.from_packed_words(bits, lab, n_transactions=sp.n_transactions,
                                         name=name)
        print(f"[6d] {name} Fisher query at full width ({sp.n_items} x "
              f"{sp.n_transactions}), P = 8, segments of {k}", flush=True)
        q_f = SignificantPatternQuery(statistic="fisher")
        rt = RuntimeConfig(ckpt_period=k)
        got = {}
        for i, resume in ((1, None), (2, str(tmp / "6d_1"))):
            s = MinerSession(8, runtime=rt)
            rep = run(f"6d segment {i}", s, ds_f, q_f, ckpt_dir=str(tmp / f"6d_{i}"),
                      resume_from=resume, should_stop=lambda: True)[0]
            if not rep.partial or not rep.ckpt_path.endswith(f"step_{i * k}"):
                raise AssertionError(f"(6d) segment {i}: {rep.ckpt_path}")
            ckpt_line(f"6d segment {i}", s)
            got.update(step_digests(str(tmp / f"6d_{i}"), load_frontier, CARRY_FIELDS))
        if got != FRONTIER_EXPECT["steps"]:
            raise AssertionError(f"(6d) frontier digests {got}, expected the JAX "
                                 f"package's {FRONTIER_EXPECT['steps']}")
        print(f"  (6d) frontiers at steps {k} and {2 * k} equal the JAX "
              f"package's: {got}", flush=True)
        del ds_f

        # (6e) alz_rec_30 closed-frequent, a checkpoint every superstep
        name, min_sup, closed, sha = FULL_WIDTH[1]
        bits, lab, _, sp = paper_problem_packed(name)
        ds_z = Dataset.from_packed_words(bits, lab, n_transactions=sp.n_transactions,
                                         name=name)
        print(f"[6e] {name} closed-frequent ({sp.n_items} items), ckpt_period 1, "
              "P = 8; kill, resume on 4", flush=True)
        q_z = ClosedFrequentQuery(min_sup=min_sup)
        rt1 = RuntimeConfig(ckpt_period=1)
        s = MinerSession(8, runtime=rt1)
        rep = run("6e checkpointed", s, ds_z, q_z, ckpt_dir=str(tmp / "6e_full"))[0]
        ckpt_line("6e", s)
        check_sha("6e checkpointed", rep, sha)
        killed(MinerSession(8, runtime=rt1), ds_z, q_z,
               FaultPlan(die_after_segments=1), ckpt_dir=str(tmp / "6e"))
        rep = run("6e resume on 4", MinerSession(4, runtime=rt1), ds_z, q_z,
                  resume_from=str(tmp / "6e"))[0]
        check_sha("6e resume on 4", rep, sha)
        if rep.n_significant != closed or not rep.phases[0].resumed:
            raise AssertionError(f"(6e) {rep.n_significant} sets, expected {closed}")
        del ds_z

        # (6f) the CLI with every new flag; its artifacts validate
        print("[6f] the mine CLI: --trace-period 1 --ckpt-period 8", flush=True)
        f = {n: str(tmp / n) for n in ("ck", "t.json", "m.prom", "blob.json")}
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.mine", "--devices", "8",
             "--pipeline", "fused23", "--trace-period", "1", "--ckpt-dir", f["ck"],
             "--ckpt-period", "8", "--trace-out", f["t.json"], "--metrics-out",
             f["m.prom"], "--json-out", f["blob.json"]],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
        if cli.returncode != 0:
            raise AssertionError(f"(6f) the CLI failed:\n{cli.stderr[-4000:]}")
        with open(f["blob.json"]) as fh:
            blob = json.load(fh)
        if "superstep_trace" not in blob or blob["ckpt"]["writes"] <= 0:
            raise AssertionError(f"(6f) blob lacks its trace/ckpt keys: {blob}")
        val = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.validate", "--chrome",
             f["t.json"], "--prom", f["m.prom"]],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
        if val.returncode != 0 or val.stdout.count("[ok]") != 2:
            raise AssertionError(f"(6f) validate: {val.stdout}{val.stderr[-2000:]}")
        print(f"  (6f) CLI: significant {blob['significant']}, ckpt {blob['ckpt']}; "
              f"{val.stdout.strip()}", flush=True)

        # (6g) what the trace and the segments cost on query (a), warm
        print("[6g] query (a) warm, P = 8, three rounds of: classic, segmented "
              "(no writer), segmented with checkpoints, traced", flush=True)
        variants = {"classic": RuntimeConfig(),
                    "segmented": RuntimeConfig(ckpt_period=8),
                    "segmented+ckpt": RuntimeConfig(ckpt_period=8),
                    "traced": RuntimeConfig(trace_period=1, trace_cap=256)}
        sessions = {v: MinerSession(8, runtime=rt) for v, rt in variants.items()}
        for v, s in sessions.items():
            s.run(ds_a, q_a)                      # build the programs
        walls = {v: [] for v in variants}
        peaks = {}
        for i in range(3):
            # the order of the three without a writer turns each round; the
            # run that writes ~440 MB of checkpoints goes last, so the
            # host's write-back of its files never lands in another's wall
            order = ["classic", "segmented", "traced"]
            for v in order[i:] + order[:i] + ["segmented+ckpt"]:
                s = sessions[v]
                kw = {"ckpt_dir": str(tmp / f"6g_{i}")} if v == "segmented+ckpt" else {}
                rep, wall, peak = run(f"6g {v} #{i + 1}", s, ds_a, q_a, **kw)
                bad = report_diffs(rep_a, rep)
                if bad:
                    raise AssertionError(f"(6g) {v} != (a) in {bad}")
                walls[v].append(wall)
                peaks[v] = peak
        ckpt_line("6g segmented+ckpt", sessions["segmented+ckpt"])
        steps = sum(p.supersteps for p in rep_a.phases)
        for v in ("classic", "traced"):
            _, dev, wall_p = _profile(lambda: sessions[v].run(ds_a, q_a))
            spans = {e["name"] for e in sessions[v].tracer.events()}
            _profile_line(f"6g {v}", {k: x for k, x in dev.items() if k not in spans},
                          min(walls[v]), wall_p, steps=steps)
        for v in variants:
            best = min(walls[v])
            print(f"  (6g) {v}: walls {[round(w, 4) for w in walls[v]]} s, best "
                  f"{best:.4f} s ({steps / best:.1f} supersteps/s, "
                  f"{100 * (best / min(walls['classic']) - 1):+.1f}% vs classic), "
                  f"peak {peaks[v]:.1f} MiB", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def _busy_union_s(prof, until_s: float) -> float | None:
    """Seconds of a profile's first `until_s` in which at least one kernel
    ran on the card: the union of the CUDA activities' intervals (times
    from the profile's start), since kernels of two workers' streams may
    overlap (host annotations left out); None when the profile holds no
    device activity."""
    from torch.autograd import DeviceType

    until_us = until_s * 1e6
    spans = sorted((max(e.time_range.start, 0.0), min(e.time_range.end, until_us))
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    spans = [(lo, hi) for lo, hi in spans if hi > lo]
    if not spans:
        return None
    busy, reach = 0.0, -math.inf
    for lo, hi in spans:
        if hi > reach:
            busy += hi - max(lo, reach)
            reach = hi
    return busy / 1e6


def phase7(ds_a, session_a, rep_a, launched: set) -> dict:
    """Phase 7: serving on the card (7a-7d).

    `ds_a` is phase 4's 1,191-item Dataset on the card, `session_a` the warm
    P = 8 session of the main path and `rep_a` its report of query (a).
    Every run adds its kernel launch shapes to `launched` (3b checks them).
    Checkpoints go under build/chip_smoke/, removed at the end.  Returns
    {run: kernel launches}.
    """
    import asyncio

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import (
        Dataset,
        MinerSession,
        RuntimeConfig,
        SignificantPatternQuery,
    )
    from repro_torch.core import engine
    from repro_torch.data.synthetic import paper_problem_packed
    from repro_torch.kernels.support_count import kernel
    from repro_torch.results import ResultStream
    from repro_torch.serve import MiningService, ServeConfig, WarmupSpec, percentile
    from repro_torch.testing import FaultPlan, injected

    tmp = ROOT / "build" / "chip_smoke"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    q_a = make_query("a")
    expect_a = QUERY_EXPECT["a"][1]
    sha_a = expect_a["results_sha256"]
    warm = [WarmupSpec(ds_a.bucket, statistic="fisher", pipeline="fused23")]
    launches: dict[str, int] = {}

    def counted(tag, fn):
        out, wall, n, shapes = _counted(fn)
        launched.update(shapes)
        launches[tag] = n
        if n <= 0:
            raise AssertionError(f"(7) {tag}: the kernel was never launched")
        return out, wall, n, shapes

    try:
        # (7a) query (a) streamed on the warm session of the main path
        print(f"[7a] query (a) on the warm session, ResultStream(head_k={TOPK})",
              flush=True)
        heads = []
        t_run = [0.0]

        def streamed():
            t_run[0] = time.perf_counter()
            return session_a.run(ds_a, q_a, stream=ResultStream(
                head_k=TOPK,
                on_head=lambda p: heads.append((time.perf_counter() - t_run[0], p))))

        rep, wall, n, shapes = counted("7a streamed", streamed)
        if len(heads) != 1:
            raise AssertionError(f"(7a) the head was delivered {len(heads)} times")
        t_head, head = heads[0]
        if head != rep.results.patterns[:TOPK]:
            raise AssertionError("(7a) the streamed head != the final top 10")
        bad = expect_diffs(rep, expect_a) + report_diffs(rep_a, rep)
        if bad:
            raise AssertionError(f"(7a) streamed (a) differs: {bad}")
        print(f"  (7a) head of {len(head)} at {t_head:.4f} s of a {wall:.4f} s "
              f"query ({100 * t_head / wall:.1f}%); streamed == unstreamed == "
              f"the JAX package's; kernel launches {n} by (B, M, W): {shapes}",
              flush=True)

        # (7b) fleets of 1, 2 and 4 sessions draining reseeded requests
        work = []
        for seed in range(SERVE_REQUESTS):
            bits, lab, _, sp = paper_problem_packed("hapmap_dom_20", scale_items=0.1,
                                                    seed=seed)
            ds = Dataset.from_packed_words(bits, lab, n_transactions=sp.n_transactions,
                                           name=sp.name)
            if ds.bucket != ds_a.bucket:
                raise AssertionError(f"(7b) seed {seed}: bucket {ds.bucket}")
            # a dataset's first deal counts the root's supports; count them
            # here, so the direct runs and each fleet launch alike
            engine.root_supports(ds.packed)
            work.append((ds, SignificantPatternQuery(
                alpha=SERVE_ALPHAS[seed % len(SERVE_ALPHAS)], pipeline="fused23",
                statistic="fisher")))
        print(f"[7b] {SERVE_REQUESTS} requests (seeds 0-{SERVE_REQUESTS - 1}, alpha "
              f"{SERVE_ALPHAS}, fused23/Fisher), direct on the warm session, then "
              f"served by fleets of {SERVE_FLEETS} sessions of P = 8", flush=True)
        direct_sha, direct_walls, direct_total = [], [], 0
        for i, (ds, q) in enumerate(work):
            rep, wall, n, shapes = _counted(lambda: session_a.run(ds, q))
            launched.update(shapes)
            direct_total += n
            direct_sha.append(results_sha256(rep.results))
            direct_walls.append(wall)
            if i == 0 and expect_diffs(rep, expect_a):
                raise AssertionError(f"(7b) seed 0 != (a): {expect_diffs(rep, expect_a)}")
        print(f"  direct: {sum(direct_walls):.3f} s in all "
              f"({SERVE_REQUESTS / sum(direct_walls):.3f} qps serial), walls "
              f"{min(direct_walls):.3f}-{max(direct_walls):.3f} s, kernel "
              f"launches {direct_total}", flush=True)

        async def drain(service, items):
            """Closed loop, a client per worker: [ServeResult] in item order."""
            results = [None] * len(items)
            todo = iter(range(len(items)))

            async def client():
                for i in todo:
                    results[i] = await service.mine(*items[i])

            await asyncio.gather(*[client() for _ in range(service.size)])
            return results

        async def serve(size):
            svc = MiningService(size=size, n_miners=8, warmups=warm)
            compiled = await svc.start()
            streams = {w.stream for w in svc.fleet.workers}
            if None in streams or len(streams) != size:
                raise AssertionError(f"(7b) fleet {size}: streams {streams}")
            # the counters are set to 0 just before the drain, read just after
            kernel.reset_counts()
            t0 = time.perf_counter()
            res = await drain(svc, work)
            wall_d = time.perf_counter() - t0   # each request synchronised
            n_d, shapes_d = kernel.launches, dict(kernel.launch_shapes)
            # the idle share: the device's activity (only: the host's ops
            # of four threads would take minutes to post-process) over a
            # window of a second pass while every worker serves a request
            lead, window = IDLE_WINDOW
            second = asyncio.ensure_future(drain(svc, work[1:1 + size]))
            await asyncio.sleep(lead)
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            tp = time.perf_counter()
            await asyncio.sleep(window)
            inside = not second.done()
            wall_p = time.perf_counter() - tp
            prof.stop()
            await second
            await svc.stop()
            if not inside:
                raise AssertionError(f"(7b) fleet {size}: the pass ended inside "
                                     "the profile's window")
            return (compiled, res, wall_d, n_d, shapes_d, _busy_union_s(prof, wall_p),
                    wall_p)

        for size in SERVE_FLEETS:
            t7 = time.perf_counter()
            compiled, res, wall_d, n_d, shapes_d, busy_p, wall_p = asyncio.run(serve(size))
            t7 = time.perf_counter() - t7
            launched.update(shapes_d)
            launches[f"7b fleet {size}"] = n_d
            bad = [i for i, r in enumerate(res)
                   if not r.ok or results_sha256(r.report.results) != direct_sha[i]]
            cold = sum(1 for r in res if r.ok and r.report.cold)
            if bad or cold or n_d != direct_total:
                raise AssertionError(
                    f"(7b) fleet {size}: requests {bad} differ from their direct "
                    f"runs, warm_violations {cold}, kernel launches {n_d} "
                    f"(direct {direct_total})")
            if expect_diffs(res[0].report, expect_a):
                raise AssertionError(f"(7b) fleet {size}: seed 0 != (a)")
            lat = [r.total_s for r in res]
            if busy_p is None:
                busy_txt = "the profiler saw no device time (idle not measured)"
            else:
                busy_txt = (f"device busy {busy_p * 1e3:.3f} ms of a {wall_p:.3f} s "
                            f"window with {size} requests in flight: idle "
                            f"{100 * (1 - busy_p / wall_p):.2f}%")
            print(f"  (7b) fleet of {size} ({t7:.1f} s with its warmup and "
                  f"profiled pass): warmup built {compiled} programs; "
                  f"{len(res)} served in {wall_d:.3f} s = "
                  f"{len(res) / wall_d:.3f} qps; latency p50 "
                  f"{percentile(lat, 50):.4f} p90 {percentile(lat, 90):.4f} max "
                  f"{max(lat):.4f} s; service mean "
                  f"{sum(r.service_s for r in res) / len(res):.4f} s (direct "
                  f"{sum(direct_walls) / len(direct_walls):.4f}); sessions "
                  f"{sorted({r.session_id for r in res})}; batch sizes "
                  f"{sorted({r.batch_size for r in res})}; kernel launches {n_d} "
                  f"(= direct); warm_violations 0; {busy_txt}", flush=True)

        # (7c) a retry to success, then a deadline that stops a request
        print("[7c] one request failed once by an injected fault, then one with a "
              "0.2 s deadline on a fleet with ckpt_period 8", flush=True)

        async def retried():
            svc = MiningService(size=1, n_miners=8, warmups=warm)
            await svc.start()
            with injected(FaultPlan(serve_fail_first_n=1)):
                res = await svc.mine(ds_a, q_a)
            await svc.stop()
            return res

        res = counted("7c retry", lambda: asyncio.run(retried()))[0]
        if (res.outcome, res.attempts) != ("ok", 2) or \
                results_sha256(res.report.results) != sha_a:
            raise AssertionError(f"(7c) retry: {res.outcome} after {res.attempts} "
                                 f"attempts ({res.reason})")
        seg = RuntimeConfig(ckpt_period=8)

        async def deadlined():
            svc = MiningService(size=1, n_miners=8, runtime=seg, warmups=warm,
                                config=ServeConfig(ckpt_root=str(tmp / "7c")))
            await svc.start()
            res = await svc.mine(ds_a, q_a, timeout_s=0.2)
            await svc.stop()
            return res

        part, wall_part = counted("7c partial", lambda: asyncio.run(deadlined()))[:2]
        if part.outcome != "partial" or not part.report.partial or \
                not (part.ckpt_path or "").startswith(str(tmp / "7c")):
            raise AssertionError(f"(7c) deadline: {part.outcome} ({part.reason}), "
                                 f"ckpt {part.ckpt_path}")
        resume_dir = os.path.dirname(os.path.dirname(part.ckpt_path))
        rep = counted("7c resumed", lambda: MinerSession(8, runtime=seg).run(
            ds_a, q_a, resume_from=resume_dir))[0]
        if results_sha256(rep.results) != sha_a or rep.partial or \
                not rep.phases[0].resumed:
            raise AssertionError(f"(7c) the resumed partial: {rep.summary()}")
        print(f"  (7c) retry: ok on attempt {res.attempts}, (a)'s sha; deadline: "
              f"partial after {part.total_s:.3f} s, "
              f"{len(part.report.results)} patterns so far, "
              f"{sum(p.supersteps for p in part.report.phases)} supersteps, "
              f"checkpoint {os.path.relpath(part.ckpt_path, tmp)}; its resume "
              f"gives (a)'s sha", flush=True)

        # (7d) the serving CLI on the card
        print("[7d] python -m repro_torch.launch.mine_serve --smoke --concurrency 2",
              flush=True)
        blob_path = tmp / "serve.json"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.mine_serve", "--smoke",
             "--concurrency", "2", "--json-out", str(blob_path)],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
        if cli.returncode != 0:
            raise AssertionError(f"(7d) the CLI failed:\n{cli.stderr[-4000:]}")
        with open(blob_path) as fh:
            blob = json.load(fh)
        if blob["failed"] or blob["warm_violations"] or blob["ok"] != blob["queries"]:
            raise AssertionError(f"(7d) {blob}")
        print(f"  (7d) CLI: {blob['ok']}/{blob['queries']} ok, failed 0, "
              f"warm_violations 0, {blob['achieved_qps']} qps, p50 "
              f"{blob['p50_s']} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def phase8(ds_a, rep_a, launched: set) -> dict:
    """Phase 8: topology on the card (8a forced shapes, 8b a gloo cluster).

    `ds_a` is phase 4's 1,191-item Dataset on the card and `rep_a` the main
    path's report of query (a).  Every run adds its kernel launch shapes to
    `launched` (3b checks them).  Returns {run: kernel launches}.
    """
    from repro_torch.api import MinerSession, RuntimeConfig
    from repro_torch.kernels.support_count import autotune
    from repro_torch.topo import Topology, bootstrap
    from repro_torch.topo.worker import WORKER

    sha_a = QUERY_EXPECT["a"][1]["results_sha256"]
    launches = {}
    t8 = time.perf_counter()

    def check(tag, rep, want, who):
        bad = []
        if results_sha256(rep.results) != sha_a:
            bad.append("results_sha256")
        if [p.supersteps for p in rep.phases] != want["supersteps"]:
            bad.append(f"supersteps {[p.supersteps for p in rep.phases]}")
        if [stats_digest(p.output.stats) for p in rep.phases] != want["stats_sha256"]:
            bad.append("stats")
        if bad:
            raise AssertionError(f"(8a) {tag} {who} != the JAX package's forced run: {bad}")

    # ---- 8a: forced shapes on one process; the first one profiled too (a
    # profile's post-processing costs tens of seconds on a slow host)
    for i, (tag, want) in enumerate(TOPO_EXPECT.items()):
        topo = Topology(*want["shape"])
        untraced = MinerSession(8, runtime=RuntimeConfig(topology=topo))
        traced = MinerSession(8, runtime=RuntimeConfig(topology=topo, trace_period=1))
        _, cold, _, _ = _counted(lambda: untraced.run(ds_a, make_query("a")))
        rep, wall, n_launch, shapes = _counted(lambda: untraced.run(ds_a, make_query("a")))
        launched.update(shapes)
        launches[f"8a {tag}"] = n_launch
        check(tag, rep, want, "warm")
        if n_launch <= 0 or any(p.kernel_impl != "cuda" for p in rep.phases):
            raise AssertionError(f"(8a) {tag}: {n_launch} kernel launches")
        rep_t = traced.run(ds_a, make_query("a"))
        check(tag, rep_t, want, "traced")
        donated = [{k: v["donated"] for k, v in p.steal_by_round.items()}
                   for p in rep_t.phases]
        if donated != want["donated_by_round"]:
            raise AssertionError(f"(8a) {tag}: steal by round {donated}")
        tiers = {v["tier"] for p in rep_t.phases for v in p.steal_by_round.values()}
        steps = sum(p.supersteps for p in rep.phases)
        print(f"  (8a) {tag}: cold {cold:.3f} s, warm {wall:.3f} s "
              f"(flat (a) {rep_a.wall_s:.3f} s in phase 4); supersteps "
              f"{'+'.join(str(p.supersteps) for p in rep.phases)} ({steps / wall:.1f}/s); "
              f"kernel launches {n_launch} {shapes}; steals "
              f"{sum(p.steals for p in rep.phases)}; tiers {sorted(tiers)}, fairness "
              f"{[{k: round(v, 4) for k, v in p.tier_fairness.items()} for p in rep_t.phases]}"
              f"; = JAX forced {tag} and flat (a)'s sha", flush=True)
        if i > 0:
            continue
        rep_p, dev, wall_p = _profile(lambda: untraced.run(ds_a, make_query("a")))
        bad = report_diffs(rep, rep_p)
        if bad:
            raise AssertionError(f"(8a) {tag}: profiled run differs in {bad}")
        seen = sum(n for k, (n, _) in dev.items() if "support_count_kernel" in k)
        if seen == n_launch:
            _profile_line(f"(8a) {tag}", dev, wall, wall_p, steps=steps)
        else:
            print(f"  profile of (8a) {tag}: the profiler saw {seen} of {n_launch} "
                  "kernel launches (idle share not measured)", flush=True)
    print(f"  (8a) done in {time.perf_counter() - t8:.1f} s", flush=True)

    # ---- 8b: a gloo cluster of processes on the one card
    n_proc, per = CLUSTER
    want = TOPO_EXPECT[f"{n_proc}x{per}"]
    spec = dict(dataset={"paper": "hapmap_dom_20", "scale_items": 0.1},
                query=dict(zip(("pipeline", "statistic"), QUERY_EXPECT["a"][0])),
                topology="hier", device="cuda", runs=2)
    card, sms = autotune.card_info()
    tile = autotune.choose_blocks(16 * per, ds_a.bucket.items, ds_a.bucket.words,
                                  card=card, sms=sms)
    t0 = time.perf_counter()
    outs = bootstrap.launch_local_cluster(WORKER, spec, n_processes=n_proc,
                                          miners_per_process=per, timeout=300,
                                          all_processes=True)
    cluster_wall = time.perf_counter() - t0
    expand = (16 * per, ds_a.bucket.items, ds_a.bucket.words)
    for out in outs:
        pid = out["process_id"]
        steps = sum(p["supersteps"] for p in out["phases"])
        shapes = {tuple(k): n for k, n in out["launch_shapes"]}
        launched.update(shapes)
        launches[f"8b process {pid}"] = sum(shapes.values())
        bad = []
        if out["results_sha256"] != sha_a:
            bad.append("results_sha256")
        if [p["supersteps"] for p in out["phases"]] != want["supersteps"]:
            bad.append("supersteps")
        if [stats_digest(p["stats"]) for p in out["phases"]] != want["stats_sha256"]:
            bad.append("stats")
        if shapes.get(expand, 0) <= 0:
            bad.append(f"no launch at {expand}")
        # every rank chooses the tile this process chooses at each shape
        tiles = {(*k[:3], tuple(k[3])): n for k, n in out["launch_tiles"]}
        bad += [f"tile {k}" for k in tiles
                if k[3] != autotune.choose_blocks(*k[:3], card=card, sms=sms)]
        if any(tuple(p["kernel_blocks"]) != tile for p in out["phases"]):
            bad.append(f"phases' kernel_blocks {[p['kernel_blocks'] for p in out['phases']]}")
        if bad:
            raise AssertionError(f"(8b) process {pid}: {bad}")
        coll = out["collectives"]
        print(f"  (8b) process {pid} of {n_proc} ({out['miners_here']} of "
              f"{out['n_miners']} miners): walls {[round(w, 3) for w in out['walls']]} s "
              f"(cold, warm); supersteps "
              f"{'+'.join(str(p['supersteps']) for p in out['phases'])}; kernel "
              f"launches {sum(shapes.values())} {shapes}, {shapes[expand]} at {expand} "
              f"with tile {tile}; "
              f"collectives {coll['calls']} in {coll['seconds']:.3f} s "
              f"({1e3 * coll['seconds'] / steps:.3f} ms per superstep); "
              f"= 8a {n_proc}x{per} and flat (a)'s sha", flush=True)
    print(f"  (8b) cluster of {n_proc} processes on one card: {cluster_wall:.1f} s "
          "from launch to the last answer (process start, torch import, "
          "dataset, cold and warm query)", flush=True)
    return launches


def phase9a() -> dict:
    """Phase 9a: every candidate tile of every TILE_B x TILE_M x TILE_W
    shape against the plain version, bit for bit.  Returns {"shapes",
    "launches", "mismatched"}; a mismatch fails the run."""
    import torch

    from repro_torch.kernels.support_count import autotune, kernel
    from repro_torch.kernels.support_count.ref import support_count_ref

    gen = torch.Generator(device="cuda").manual_seed(9)
    n_shapes = n_launch = 0
    bad = []
    for w in TILE_W:
        for m in TILE_M:
            db = torch.randint(-2**31, 2**31, (m, w), dtype=torch.int32,
                               device="cuda", generator=gen)
            db[m // 2] = -1
            for b in TILE_B:
                occ = torch.randint(-2**31, 2**31, (b, w), dtype=torch.int32,
                                    device="cuda", generator=gen)
                occ[0] = -1
                want = support_count_ref(occ, db)
                for tile in autotune.candidate_blocks(b, m, w):
                    got = kernel.support_count_cuda(occ, db, blocks=tile)
                    n_launch += 1
                    if not torch.equal(got, want):
                        bad.append(((b, m, w), tile))
                    del got
                n_shapes += 1
                del want
    torch.cuda.synchronize()
    if bad:
        raise AssertionError(f"(9a) kernel != plain version at {bad[:10]} "
                             f"({len(bad)} of {n_launch})")
    return dict(shapes=n_shapes, launches=n_launch, mismatched=len(bad))


def measure_tiles(shapes) -> list[dict]:
    """Phase 9b, in a child process: `measure_blocks` with the profiler's
    device time at each shape, beside the chosen tile, the bound and the
    library call's device time.  Rows of the seed table go to
    build/chip_smoke/autotune_seed.json (not loaded)."""
    import torch

    from repro_torch.kernels.support_count import autotune

    out, table = [], []
    card, sms = autotune.card_info()
    for b, m, w in shapes:
        rows = autotune.measure_blocks(b, m, w, device_time=True)
        table += rows
        chosen = list(autotune.choose_blocks(b, m, w, card=card, sms=sms))
        gen = torch.Generator(device="cuda").manual_seed(0)
        occ = torch.randint(-2**31, 2**31, (b, w), dtype=torch.int32,
                            device="cuda", generator=gen)
        db = torch.randint(-2**31, 2**31, (m, w), dtype=torch.int32,
                           device="cuda", generator=gen)
        lib, _, lib_name = _library(occ, db)
        library_ms = _device_ms(lib)
        del lib, occ, db
        bound_ms, bound_by = _bound(b, m, w)
        mine = next(r for r in rows if r["blocks"] == chosen)
        best = rows[0]
        print(f"  (9b) {b:>4} x {m:>6} x {w:>3}: chosen {tuple(chosen)} "
              f"{_us(mine['device_us'])} us (events {mine['time_us']:.2f}); best "
              f"{tuple(best['blocks'])} {_us(best['device_us'])} us; bound "
              f"{bound_ms * 1e3:.3f} us ({bound_by}); library {lib_name} "
              f"{_us(None if library_ms is None else library_ms * 1e3)} us", flush=True)
        for r in rows:
            print(f"        {str(tuple(r['blocks'])):>15}  device {_us(r['device_us'])} us"
                  f"  events {r['time_us']:8.2f} us  modeled {r['modeled_us']:8.3f} us"
                  f"  smem {r['smem_kib']:6.1f} KiB"
                  + ("  <- chosen" if r["blocks"] == chosen else ""), flush=True)
        out.append(dict(shape=[b, m, w], chosen=chosen, chosen_us=mine["device_us"],
                        best=best["blocks"], best_us=best["device_us"],
                        bound_us=bound_ms * 1e3, bound_by=bound_by,
                        library_us=None if library_ms is None else library_ms * 1e3,
                        library=lib_name,
                        tiles=[[r["blocks"], r["device_us"], r["time_us"],
                                r["modeled_us"]] for r in rows]))
    path = ROOT / "build" / "chip_smoke" / "autotune_seed.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    autotune.save_seed_table(str(path), table)
    print(f"  (9b) seed table of {len(table)} rows: {path.relative_to(ROOT)}", flush=True)
    return out


def _us(x) -> str:
    return "n.m." if x is None else f"{x:.3f}"


def measure_tiles_in_child(shapes) -> list[dict]:
    """`measure_tiles(shapes)` in a fresh process of this script (the
    profiler late in a run drops launches; see check_kernel_in_child)."""
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--measure-tiles",
         json.dumps([list(s) for s in shapes])],
        capture_output=True, text=True, timeout=600,
    )
    lines = proc.stdout.rstrip("\n").splitlines()
    print("\n".join(lines[:-1]), flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"9b child failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1])


def phase9(ds_a, rep_a, tiles_a: dict, acts_per_step, launched: set) -> dict:
    """Phase 9: the kernel's tile (9a-9d, see the module doc).  `ds_a` is
    phase 4's 1,191-item Dataset on the card, `rep_a` the main path's
    report of query (a) and `tiles_a` its launches by (B, M, W, tile);
    `acts_per_step` phase 4's device activities per superstep.  Returns
    {"9a": ..., "9b": rows, "9c launches": n, "9d": ...}."""
    from repro_torch.api import MinerSession, RuntimeConfig
    from repro_torch.kernels.support_count import autotune, kernel
    from repro_torch.launch.op_cost import count_costs

    out = {}
    card, sms = autotune.card_info()
    expand = (16 * 8, ds_a.bucket.items, ds_a.bucket.words)
    sha_a = QUERY_EXPECT["a"][1]["results_sha256"]

    t0 = time.perf_counter()
    out["9a"] = phase9a()
    print(f"  (9a) every candidate tile == plain version at {out['9a']['shapes']} "
          f"shapes (B {TILE_B} x M {TILE_M} x W {TILE_W}), {out['9a']['launches']} "
          f"launches: mismatches 0; {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    out["9b"] = measure_tiles_in_child(TILE_SHAPES)
    print(f"  (9b) {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 9c: query (a) with a non-default tile pinned
    t0 = time.perf_counter()
    if autotune.choose_blocks(*expand, card=card, sms=sms) == PINNED_TILE:
        raise AssertionError(f"(9c) {PINNED_TILE} is the default at {expand}")
    pinned = MinerSession(8, runtime=RuntimeConfig(kernel_blocks=PINNED_TILE))
    rep, wall, n_launch, shapes = _counted(lambda: pinned.run(ds_a, make_query("a")))
    tiles = dict(kernel.launch_tiles)
    launched.update(shapes)
    out["9c launches"] = n_launch
    bad = [f"{k}: {n}" for k, n in tiles.items()
           if k[3] != (PINNED_TILE if k[:3] == expand
                       else autotune.choose_blocks(*k[:3], card=card, sms=sms))]
    if (results_sha256(rep.results) != sha_a or bad or tiles.get((*expand, PINNED_TILE), 0) <= 0
            or any(p.kernel_blocks != PINNED_TILE for p in rep.phases)):
        raise AssertionError(f"(9c) pinned {PINNED_TILE}: sha "
                             f"{results_sha256(rep.results)}, tiles {tiles}, phases "
                             f"{[p.kernel_blocks for p in rep.phases]}")
    print(f"  (9c) query (a) with kernel_blocks={PINNED_TILE}: {wall:.3f} s (cold), "
          f"= (a)'s sha; launches {n_launch} by (B, M, W, tile) {tiles}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 9d: the main path's tiles, and op_cost on the card
    t0 = time.perf_counter()
    chosen = autotune.choose_blocks(*expand, card=card, sms=sms)
    bad = [f"{k}: {n}" for k, n in tiles_a.items()
           if k[3] != autotune.choose_blocks(*k[:3], card=card, sms=sms)]
    if any(p.kernel_blocks != chosen for p in rep_a.phases) or bad:
        raise AssertionError(f"(9d) (a)'s phases {[p.kernel_blocks for p in rep_a.phases]}, "
                             f"chosen {chosen}; launches off their chosen tile: {bad}")
    session = MinerSession(8)
    session.run(ds_a, make_query("a"))                 # build the programs
    reps = []
    kernel.reset_counts()
    costs = count_costs(lambda: reps.append(session.run(ds_a, make_query("a"))))
    steps = sum(p.supersteps for p in reps[0].phases)
    if results_sha256(reps[0].results) != sha_a or kernel.launches != sum(tiles_a.values()):
        raise AssertionError(f"(9d) under op_cost: sha {results_sha256(reps[0].results)}, "
                             f"launches {kernel.launches}")
    sc = costs["by_op"].get("support_count", {})
    out["9d"] = dict(chosen=list(chosen), launches=sum(tiles_a.values()),
                     aten_ops=costs["ops"], supersteps=steps,
                     aten_ops_per_step=costs["ops"] / steps,
                     support_count_items=sc.get("count", 0),
                     bytes=costs["bytes"], bit_ops=costs["bit_ops"])
    acts = "not measured" if acts_per_step is None else f"{acts_per_step:.1f}"
    print(f"  (9d) query (a): phases' kernel_blocks {[p.kernel_blocks for p in rep_a.phases]}"
          f" = choose_blocks{expand} = {chosen}; its {sum(tiles_a.values())} launches by "
          f"(B, M, W, tile) {tiles_a}; under op_cost (same sha, same launches): "
          f"{costs['ops']} aten ops over {steps} supersteps = "
          f"{costs['ops'] / steps:.1f} per superstep (phase 4: {acts} device "
          f"activities per superstep), {sc.get('count', 0)} support-count items, "
          f"{costs['bytes'] / 2**20:.1f} MiB, {costs['bit_ops']:.4g} bit operations; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def _graph_pool_bytes() -> int | None:
    """Bytes the caching allocator holds in private pools (CUDA graphs'),
    None where its snapshot names no pool."""
    import torch

    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(s["total_size"] for s in segs if tuple(s["segment_pool_id"]) != (0, 0))


def phase10() -> dict:
    """Phase 10: each superstep one CUDA graph replay.  For each of
    `GRAPH_CELLS`, P = 8: a session replaying graphs against one running
    the eager loop (`engine.step_graphs` patched off), a cold query and
    two warm ones each: every report bit-identical, the kernel launched as
    often at each shape; the replay share of the warm queries
    (`miner_superstep_replays_total` over their supersteps), the graph
    pools' bytes, the warm walls; then one more warm query under the
    profiler, whose support-count kernels on the card must equal the
    launches counted, replays included.  Returns its numbers by cell."""
    import torch

    from repro_torch.api import (
        ClosedFrequentQuery,
        Dataset,
        MinerSession,
        RuntimeConfig,
        SignificantPatternQuery,
    )
    from repro_torch.core import engine
    from repro_torch.data.synthetic import paper_problem_packed

    out = {}
    graphs_on = engine.step_graphs
    for name, batch, (kind, arg) in GRAPH_CELLS:
        bits, lab, _, sp = paper_problem_packed(name)
        ds = Dataset.from_packed_words(bits, lab, n_transactions=sp.n_transactions,
                                       name=name, device="cuda")
        query = (SignificantPatternQuery(alpha=arg, pipeline="three_phase")
                 if kind == "lamp" else ClosedFrequentQuery(min_sup=arg))
        engine.root_supports(ds.packed)   # a dataset's first deal counts them
        replays = "miner_superstep_replays_total"
        runs = {}
        for path in ("eager", "graph"):
            engine.step_graphs = graphs_on if path == "graph" else (lambda *a: False)
            try:
                session = MinerSession(8, runtime=RuntimeConfig(expand_batch=batch))
                pool0 = _graph_pool_bytes()
                runs[path] = [_counted(lambda: session.run(ds, query))]
                cold = _metric(session, replays)
                runs[path] += [_counted(lambda: session.run(ds, query)) for _ in range(2)]
            finally:
                engine.step_graphs = graphs_on
            if path == "graph":
                graph_session, cold_replays, pool = session, cold, _graph_pool_bytes()
                pool = None if pool is None or pool0 is None else pool - pool0
        for i, ((rep_e, _, n_e, sh_e), (rep_g, _, n_g, sh_g)) in enumerate(
                zip(runs["eager"], runs["graph"])):
            bad = report_diffs(rep_e, rep_g)
            if bad or (n_e, sh_e) != (n_g, sh_g):
                raise AssertionError(f"(10) {name} query {i}: graph != eager in {bad}, "
                                     f"launches {n_g} {sh_g} vs {n_e} {sh_e}")
        steps = sum(p.supersteps for r, *_ in runs["graph"] for p in r.phases)
        n_replays = _metric(graph_session, replays)
        graphs = _metric(graph_session, "miner_superstep_graphs_total")
        warm_steps = sum(p.supersteps for r, *_ in runs["graph"][1:] for p in r.phases)
        warm_share = (n_replays - cold_replays) / warm_steps
        (rep_p, _, n_p, _), dev, _ = _profile(lambda: _counted(
            lambda: graph_session.run(ds, query)))
        seen = sum(n for k, (n, _) in dev.items() if "support_count_kernel" in k)
        if seen != n_p or report_diffs(rep_p, runs["graph"][1][0]):
            raise AssertionError(f"(10) {name} profiled: the profiler saw {seen} "
                                 f"support-count kernels, {n_p} launches counted")
        walls = {path: [round(w, 4) for _, w, _, _ in runs[path][1:]] for path in runs}
        share = (_metric(graph_session, replays) - n_replays) / sum(
            p.supersteps for p in rep_p.phases)
        if min(warm_share, share) < 0.95:
            raise AssertionError(f"(10) {name}: replay share {warm_share} warm, "
                                 f"{share} profiled")
        out[name] = dict(supersteps=steps, replays=n_replays, graphs=graphs,
                         warm_share=warm_share, profiled_share=share, pool_bytes=pool,
                         walls=walls, launches=n_p, profiled_kernels=seen)
        print(f"  (10) {name} ({kind} {arg}, expand batch {batch}): graph == eager on a "
              f"cold and two warm queries (reports and launches); {steps} supersteps, "
              f"{int(n_replays)} replays of {int(graphs)} graphs (warm share "
              f"{warm_share:.4f}, profiled {share:.4f}); graph pools "
              f"{'n.m.' if pool is None else f'{pool / 2**20:.1f} MiB'}; warm walls eager "
              f"{walls['eager']} s, graph {walls['graph']} s; profiled: {seen} "
              f"support-count kernels = {n_p} launches counted", flush=True)
        if kind == "closed":
            out[f"{name} served"] = _served_eagerly(ds, batch, arg)
        del ds, graph_session, runs
    return out


def _served_eagerly(ds, batch: int, min_sup: int) -> dict:
    """(10c) closed queries at min_sup .. min_sup + 3 served by a fleet of
    two P = 8 sessions, two closed-loop clients, after one warm request
    each (the `.served` cell's shape), with the CUDA profiler started and
    stopped while both serve: every report equals a direct run's, and the
    workers, each on a stream of its own, replay no graph (a replay there
    deadlocks with the profiler's stop, `engine.on_default_stream`)."""
    import asyncio

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import ClosedFrequentQuery, MinerSession, RuntimeConfig
    from repro_torch.serve import MiningService, WarmupSpec

    runtime = RuntimeConfig(expand_batch=batch)
    queries = [ClosedFrequentQuery(min_sup=min_sup + i % 4) for i in range(40)]
    direct = MinerSession(8, runtime=runtime)
    want = {q.min_sup: results_sha256(direct.run(ds, q).results) for q in queries[:4]}
    replays = "miner_superstep_replays_total"

    async def serve():
        svc = MiningService(size=2, n_miners=8, runtime=runtime,
                            warmups=[WarmupSpec(ds.bucket, statistic=None,
                                                pipeline="three_phase")])
        await svc.start()
        try:
            await asyncio.gather(*[svc.mine(ds, q) for q in queries[:2]])
            todo, done = iter(queries), []

            async def client():
                for q in todo:
                    done.append((q, await svc.mine(ds, q)))

            async def profiled():
                await asyncio.sleep(0.2)
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.start()
                await asyncio.sleep(0.5)
                prof.stop()

            await asyncio.gather(client(), client(), profiled())
            # the fleet's sessions share one metrics registry
            n_replays = _metric(svc.fleet.workers[0].session, replays)
        finally:
            await svc.stop()
        return done, n_replays

    done, n_replays = asyncio.run(serve())
    bad = [q.min_sup for q, res in done
           if not res.ok or results_sha256(res.report.results) != want[q.min_sup]]
    steps = sum(p.supersteps for _, res in done for p in res.report.phases)
    if bad or n_replays:
        raise AssertionError(f"(10c) served: {bad} differ from direct runs; "
                             f"{n_replays} replays")
    print(f"  (10c) {len(done)} closed queries served by a fleet of 2 (two clients, "
          f"after one warm request each, profiled 0.5 s while serving) = direct runs; "
          f"{steps} supersteps, none replayed", flush=True)
    return dict(requests=len(done), supersteps=steps, replays=n_replays)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from repro_torch.api import (
        ClosedFrequentQuery,
        Dataset,
        MinerSession,
        RuntimeConfig,
    )
    from repro_torch.core.engine import EngineConfig, mine, pack_problem_from_bits
    from repro_torch.data.synthetic import paper_problem_packed
    from repro_torch.kernels.support_count import kernel
    from repro_torch.obs import SpanTracer

    t_start = time.perf_counter()

    def done(phase: str, t0: float) -> None:
        print(f"[{phase}] done in {time.perf_counter() - t0:.1f} s "
              f"({time.perf_counter() - t_start:.1f} s since start)", flush=True)

    # ---- 1. environment
    t0 = time.perf_counter()
    name_power = _nvidia_smi("name,power.limit")
    print(name_power, flush=True)
    clock_mhz = float(_nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    kind = torch.cuda.get_device_name(0)
    print(f"[1] card: {kind}; {props.multi_processor_count} SMs; max SM clock "
          f"{clock_mhz:.0f} MHz; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    done("1", t0)

    # ---- 2. build
    t0 = time.perf_counter()
    lib = kernel.build()
    print(f"[2] built {lib.relative_to(ROOT) if lib.is_relative_to(ROOT) else lib} "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    log = kernel.build_log().strip()
    print(log, flush=True)
    spills = [ln.strip() for ln in log.splitlines() if "bytes spill stores" in ln]
    if not log:
        print("[2] the library was built before this process: no ptxas report here",
              flush=True)
    elif len(spills) != len(INSTANTIATIONS) or any(
            "0 bytes spill stores, 0 bytes spill loads" not in ln for ln in spills):
        raise AssertionError(f"{len(spills)} ptxas reports for {len(INSTANTIATIONS)} "
                             "instantiations, or one spills registers (see above)")
    else:
        print(f"[2] {len(spills)} instantiations (block_m, block_w) {INSTANTIATIONS}: "
              "0 bytes spilled in each", flush=True)
    done("2", t0)

    # ---- 3. kernel vs plain version, on the card
    t0 = time.perf_counter()
    # the engine's shapes as the session's shape buckets pad them: EXPAND of
    # the 1,191-item query (B = 16 P = 128), a full reconstruction chunk of
    # it, and EXPAND at both full widths; the root's supports (B = 1, a
    # dataset's first deal) at 1,191 items and alz_rec_30; mcf7's LAMP query
    # (12,773 transactions, W = 512 words, the first shapes where the
    # operations term of the bound wins): EXPAND at P = 8 x 128, a full
    # reconstruction chunk, the last chunks at alpha 0.05 / 0.01 / 0.001
    # (6,343 / 5,614 / 4,753 records) and the root's supports
    bucket_shapes = [(128, 2048, 32), (512, 2048, 32), (128, 16384, 32),
                     (128, 262144, 16), (1, 2048, 32), (1, 262144, 16),
                     (1024, 512, 512), (512, 512, 512), (199, 512, 512),
                     (494, 512, 512), (145, 512, 512), (1, 512, 512)]
    main_shapes = [(128, 1191, 22), (512, 1191, 22)]       # exact shapes
    # (1024, 11916, 22): as 11,914 items, but every row of S starts on a
    # 16-byte boundary
    full_shapes = [(128, 12288, 22), (128, 253952, 12), (512, 11914, 22),
                   (1024, 11914, 22), (1024, 11916, 22)]
    ragged = [(b, m, w) for b in (1, 7, 33) for m in (1, 4095, 4097)
              for w in (1, 12, 23, 400)]
    # the MMA kernel's edges: one and two row fragments, a second row block;
    # M below one 64-item tile and astride one (4100: the 16-byte store
    # path); W at, just past and at twice the 8-word K step
    edges = [(b, m, w) for b in (16, 17, 129) for m in (65, 4100)
             for w in (8, 9, 16, 24)]
    print("[3] kernel vs plain version (bit-exact); per-call times by CUDA "
          "events, device times by the profiler", flush=True)
    profiled = bucket_shapes + main_shapes + full_shapes
    rows = check_kernel(profiled + ragged + edges, profiled=len(profiled))
    checked = {tuple(r["shape"]) for r in rows}
    done("3", t0)

    # ---- 4. the session API: kernel, plain version on the card, CPU
    t0 = time.perf_counter()
    db_bits, labels, _, spec = paper_problem_packed("hapmap_dom_20", scale_items=0.1)
    datasets = {dev: Dataset.from_packed_words(
        db_bits, labels, n_transactions=spec.n_transactions, name=spec.name,
        device=dev) for dev in ("cuda", "cpu")}
    bucket = datasets["cuda"].bucket
    print(f"[4] session queries on {spec.name}: {spec.n_items} items x "
          f"{spec.n_transactions} transactions, P = 8, bucket "
          f"({bucket.transactions}, {bucket.positives}, {bucket.items}), "
          f"W = {bucket.words}", flush=True)
    sessions = {
        # the main path; its spans show in the profiler's trace
        "kernel": (MinerSession(8, tracer=SpanTracer(torch_profiler=True)),
                   "cuda", "cuda"),
        "plain": (MinerSession(8, runtime=RuntimeConfig(kernel_impl="ref")),
                  "cuda", "ref"),
        "cpu": (MinerSession(8, device="cpu"), "cpu", "ref"),
    }
    launched: set = set()   # every (B, M, W) phases 4-5 launched

    def run(tag: str, who: str, label: str | None = None):
        session, dev, impl = sessions[who]
        misses = session.cache_info().misses
        torch.cuda.reset_peak_memory_stats()
        rep, wall, n_launch, shapes = _counted(
            lambda: session.run(datasets[dev], make_query(tag)))
        peak = torch.cuda.max_memory_allocated() / 2**20
        launched.update(shapes)
        added = session.cache_info().misses - misses
        steps = sum(p.supersteps for p in rep.phases)
        popped = sum(p.n_nodes for p in rep.phases)
        if any(p.kernel_impl != impl for p in rep.phases):
            raise AssertionError(f"({tag}) {who}: ran {rep.kernel_impl}, not {impl}")
        if (n_launch > 0) != (impl == "cuda"):
            raise AssertionError(f"({tag}) {who}: {n_launch} kernel launches")
        print(f"  ({label or tag}) {who} [{dev}/{impl}]: {wall:.3f} s; "
              f"{len(rep.phases)} phases, supersteps "
              f"{'+'.join(str(p.supersteps) for p in rep.phases)} "
              f"({steps / wall:.1f}/s); popped {popped} ({popped / wall:.0f}/s); "
              f"programs built {added}; kernel launches {n_launch}; "
              f"peak device memory {peak:.1f} MiB; {rep.summary()}", flush=True)
        return rep, wall, n_launch, shapes, added

    def check_expect(tag, rep):
        bad = expect_diffs(rep, QUERY_EXPECT[tag][1])
        if bad:
            raise AssertionError(f"query ({tag}) != the JAX package's: {bad}")

    # (a): cold, then warm — the warm run is the main path
    rep_cold, wall_cold, _, _, built = run("a", "kernel", "a cold")
    rep_a, wall_a, main_launches, shapes_a, built_warm = run("a", "kernel", "a warm")
    tiles_a = dict(kernel.launch_tiles)
    if built_warm:
        raise AssertionError(f"the warm query (a) built {built_warm} programs")
    if main_launches <= 0:
        raise AssertionError("the main path launched no support_count kernel")
    expand_shape = (16 * 8, bucket.items, bucket.words)
    if expand_shape not in shapes_a:
        raise AssertionError(f"(a) never launched at {expand_shape}: {shapes_a}")
    print(f"  (a) warm: kernel launches by (B, M, W): {shapes_a}", flush=True)
    reports = {"a": {"kernel": rep_a}}
    bad = report_diffs(rep_cold, rep_a)
    if bad:
        raise AssertionError(f"(a) cold != warm in {bad}")
    for tag in ("a", "b", "c"):
        # the CPU, at ~30 s a query, repeats (a) only
        whos = ("plain", "cpu") if tag == "a" else ("plain",)
        for who in ("kernel",) + whos:
            if (tag, who) != ("a", "kernel"):
                reports.setdefault(tag, {})[who] = run(tag, who)[0]
        for who in whos:
            bad = report_diffs(reports[tag]["kernel"], reports[tag][who])
            if bad:
                raise AssertionError(f"({tag}) kernel != {who} in {bad}")
        check_expect(tag, reports[tag]["kernel"])
    rep_d = run("d", "kernel")[0]
    check_expect("d", rep_d)
    print(f"  (a), (b), (c): kernel == plain (== CPU for (a)), MineReports and ResultSet "
          f"exports; (a)-(d) equal the JAX package's values; main-path kernel "
          f"launches {main_launches} over "
          f"{sum(p.supersteps for p in rep_a.phases)} supersteps", flush=True)

    # where the time goes: one more warm kernel run of (a) under the profiler
    session_k = sessions["kernel"][0]
    rep_p, dev, wall_p = _profile(lambda: session_k.run(datasets["cuda"],
                                                        make_query("a")))
    # the session's spans, should a torch build not flag their device
    # ranges as annotations
    spans = {e["name"] for e in session_k.tracer.events()}
    dev = {k: v for k, v in dev.items() if k not in spans}
    bad = report_diffs(rep_a, rep_p)
    if bad:
        raise AssertionError(f"(a) profiled run differs in {bad}")
    _profile_line("(a)", dev, wall_a, wall_p,
                  steps=sum(p.supersteps for p in rep_a.phases))
    acts_per_step = (sum(n for n, _ in dev.values())
                     / sum(p.supersteps for p in rep_a.phases)) if dev else None
    if dev:
        for k, (n, us) in sorted(dev.items(), key=lambda kv: -kv[1][1])[:8]:
            print(f"    {us / 1e3:9.3f} ms  {n:6d} x  {k[:100]}", flush=True)
    done("4", t0)

    # ---- 5. the paper's full widths: mode count and the closed-frequent query
    t0 = time.perf_counter()
    print("[5] full widths, P = 8: mode count in turns (kernel, plain, plain, "
          "kernel; then kernel under the profiler), then the closed-frequent "
          "query through the session (kernel, plain)", flush=True)
    for name, min_sup, closed, sha in FULL_WIDTH:
        bits, lab, _, sp = paper_problem_packed(name)
        pk = pack_problem_from_bits(bits, lab, n=sp.n_transactions, device="cuda")
        outs = {}
        for impl in ("auto", "ref", "ref", "auto"):
            cfg = EngineConfig(kernel_impl=impl, max_steps=4000)
            out, wall, n_launch, shapes = _counted(
                lambda: mine(packed=pk, mode="count", min_sup=min_sup, cfg=cfg,
                             n_miners=8))
            launched.update(shapes)
            outs.setdefault(impl, out)
            last_wall = wall
            bad = mine_output_diffs(outs[impl], out)
            if bad:
                raise AssertionError(f"{name} ({impl}): runs differ in {bad}")
            print(f"  {name} {sp.n_items} x {sp.n_transactions} ({impl}): "
                  f"{wall:.3f} s, {out.supersteps} supersteps, closed sets "
                  f"{int(out.hist.sum())}, popped {int(out.stats['popped'].sum())}, "
                  f"kernel launches {n_launch}", flush=True)
        bad = mine_output_diffs(outs["auto"], outs["ref"])
        if bad:
            raise AssertionError(f"{name}: kernel != plain in {bad}")
        if int(outs["auto"].hist.sum()) != closed:
            raise AssertionError(f"{name}: {int(outs['auto'].hist.sum())} closed "
                                 f"sets, expected {closed}")
        cfg = EngineConfig(kernel_impl="auto", max_steps=4000)
        out, dev, wall_p = _profile(lambda: mine(packed=pk, mode="count",
                                                 min_sup=min_sup, cfg=cfg, n_miners=8))
        bad = mine_output_diffs(outs["auto"], out)
        if bad:
            raise AssertionError(f"{name} (profiled): runs differ in {bad}")
        _profile_line(f"{name} count (kernel)", dev, last_wall, wall_p)
        del pk

        ds = Dataset.from_packed_words(bits, lab, n_transactions=sp.n_transactions,
                                       name=name)
        reps = {}
        for who in ("kernel", "plain"):
            session = sessions[who][0]
            rep, wall, n_launch, shapes = _counted(
                lambda: session.run(ds, ClosedFrequentQuery(min_sup=min_sup)))
            if who == "kernel":
                launched.update(shapes)
            reps[who] = rep
            print(f"  {name} closed-frequent ({who}): {wall:.3f} s, bucket "
                  f"({ds.bucket.transactions}, {ds.bucket.positives}, "
                  f"{ds.bucket.items}), supersteps {rep.phases[0].supersteps}, "
                  f"closed {rep.n_significant}, patterns {len(rep.results)}, "
                  f"kernel launches {n_launch} {shapes}", flush=True)
        bad = report_diffs(reps["kernel"], reps["plain"])
        if bad:
            raise AssertionError(f"{name} closed-frequent: kernel != plain in {bad}")
        got = (reps["kernel"].n_significant, len(reps["kernel"].results),
               results_sha256(reps["kernel"].results))
        if got != (closed, closed, sha):
            raise AssertionError(f"{name} closed-frequent: {got}, expected the "
                                 f"JAX package's {(closed, closed, sha)}")
        del ds
    done("5", t0)

    # ---- 6. the trace ring and fault tolerance
    t0 = time.perf_counter()
    p6_launches = phase6(datasets["cuda"], rep_a, launched)
    done("6", t0)

    # ---- 7. serving
    t0 = time.perf_counter()
    p7_launches = phase7(datasets["cuda"], sessions["kernel"][0], rep_a, launched)
    done("7", t0)

    # ---- 8. topology
    t0 = time.perf_counter()
    print("[8] topology, query (a): forced 2x4 and 4x2 on one process, then a "
          f"gloo cluster of {CLUSTER[0]} processes x {CLUSTER[1]} miners on the card",
          flush=True)
    p8_launches = phase8(datasets["cuda"], rep_a, launched)
    done("8", t0)

    # ---- 9. the kernel's tile
    t0 = time.perf_counter()
    print("[9] the kernel's tile: (a) every candidate vs the plain version, (b) "
          "every candidate timed at the main path's shapes, (c) query (a) with "
          f"{PINNED_TILE} pinned, (d) (a)'s tiles and op_cost", flush=True)
    p9 = phase9(datasets["cuda"], rep_a, tiles_a, acts_per_step, launched)
    done("9", t0)

    # ---- 10. the superstep as one CUDA graph
    t0 = time.perf_counter()
    print("[10] each superstep one CUDA graph replay: graph against eager at "
          f"{[c[0] for c in GRAPH_CELLS]}'s widths, the replay share, the graph "
          "pools, the profiler's support-count kernels against the launches", flush=True)
    p10 = phase10()
    done("10", t0)

    # ---- 3b. the kernel at every shape phases 4-9 launched, not yet checked
    t0 = time.perf_counter()
    new = sorted(launched - checked)
    print(f"[3b] kernel vs plain version at the {len(new)} shapes phases 4-9 "
          f"launched that phase 3 did not check: {new}", flush=True)
    rows += check_kernel_in_child(new)
    done("3b", t0)

    head = next(r for r in rows if tuple(r["shape"]) == expand_shape)
    print(json.dumps({"kernels": [{
        "name": "support_count",
        "route": "cuda",
        "source": "src/repro_torch/kernels/support_count/csrc/support_count.cu",
        "replaces": "src/repro/kernels/support_count/kernel.py:45",
        # launches of the main path: query (a), warm
        "launches": main_launches,
        "mismatches": sum(r["mismatches"] for r in rows),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # at (a)'s bucketed EXPAND shape: the kernel's device time
        # (profiler); call_ms is per back-to-back call
        "ms": head["device_ms"] if head["device_ms"] is not None else head["ms"],
        "call_ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        # one PyTorch matmul on operands unpacked beforehand, device time
        "library_ms": head["library_ms"],
        "library": head["library"],
        "library_m_pad": head["library_m_pad"],
        "shape": head["shape"],
        # every profiled shape: the buckets', the engine's, reconstruction's,
        # full widths' and those phases 4-5 launched
        "shapes": [r for r in rows if r["device_ms"] is not None],
        "shapes_checked": len(rows),
        # launches of each phase 6 run (trace ring, segments, resumes)
        "phase6_launches": p6_launches,
        # launches of each phase 7 run (streamed query, fleet drains summed
        # over their workers, retry, partial and its resume)
        "serve_launches": p7_launches,
        # launches of each phase 8 run (8a's warm forced shapes, each 8b
        # process's warm query)
        "phase8_launches": p8_launches,
        # the tile: template instantiations (block_m, block_w), the main
        # path's tiles by (B, M, W, tile), 9a's check, 9b's per-tile device
        # times (us), 9c's pinned run, 9d's op_cost count
        "instantiations": INSTANTIATIONS,
        "tiles": [[*k[:3], list(k[3]), n] for k, n in sorted(tiles_a.items())],
        "phase9": p9,
        # the superstep graphs at the benchmark's widths
        "phase10": p10,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--check-shapes"]:   # 3b's child (check_kernel_in_child)
        shapes = [tuple(x) for x in json.loads(sys.argv[2])]
        print(json.dumps(check_kernel(shapes, profiled=len(shapes))))
        sys.exit(0)
    if sys.argv[1:2] == ["--measure-tiles"]:  # 9b's child (measure_tiles_in_child)
        shapes = [tuple(x) for x in json.loads(sys.argv[2])]
        print(json.dumps(measure_tiles(shapes)))
        sys.exit(0)
    sys.exit(main())
