#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` (PATH or /usr/local/cuda/bin) and the checkout's
`src/`; it exits non-zero without them.  Phases, each of which fails the
run on any error:

1. environment: the card's name and power limit (nvidia-smi);
2. build: compile the support-count CUDA kernel for sm_90a from the
   checkout's source (into build/repro_torch/);
3. kernel vs plain: the kernel must equal the plain PyTorch version bit for
   bit at the engine's, the reconstruction's and ragged shapes, crossing
   every fragment and tile edge of the MMA kernel; each shape is timed
   beside its bound and, where B > 16, beside `torch._int_mm` on operands
   unpacked to {0, 1} int8 beforehand (the library yardstick, which the
   port never calls);
4. the significance query: the `fused23` staging (lamp1 -> count2d ->
   ResultSet) on hapmap_dom_20 at 1,191 items, P = 8 miners, run on the
   card with the kernel (the main path, whose kernel launches are counted),
   on the card with the plain version, and on the CPU: all three must be
   identical and give the JAX package's values;
5. the paper's full widths: mode `count` on hapmap_dom_20 (11,914 items)
   and alz_rec_30 (250,120 items), kernel against plain version, then once
   more under the profiler for the device idle share and the kernel's
   share of device time.

The second-to-last line is a JSON object with the kernel's numbers; the
last is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
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

#: the JAX package's values for the significance query (P-independent;
#: tests/test_torch_slice.py re-derives them from JAX)
QUERY_EXPECT = dict(lambda_final=8, min_sup=7, correction_factor=5140,
                    n_significant=623)
#: closed sets at the paper's full widths (BENCH_mining.json paper_scale)
FULL_WIDTH = (("hapmap_dom_20", 625, 204), ("alz_rec_30", 347, 295))


def fused23(packed, *, alpha: float = 0.05, n_miners: int = 8, cfg=None,
            statistic: str = "fisher", min_sup_floor: int = 1) -> dict:
    """The `fused23` LAMP staging (repro.api.session._pipeline_fused23) over
    the port's engine: lamp1 -> count2d, two traversals; the 2-D histogram
    gives the correction factor and the significant count, and the
    alpha-level records are filtered on the host at the exact delta."""
    from repro_torch.core.engine import EngineConfig, mine
    from repro_torch.results import build_result_set
    from repro_torch.stats import get_statistic

    if cfg is None:
        cfg = EngineConfig(out_cap=4096)  # the JAX RuntimeConfig default
    stat = get_statistic(statistic)
    ph1 = mine(packed=packed, mode="lamp1", alpha=alpha, cfg=cfg,
               n_miners=n_miners, statistic=statistic)
    min_sup = max(ph1.lam_final - 1, min_sup_floor)
    n, n_pos = packed.n, packed.n_pos
    ph2 = mine(packed=packed, mode="count2d", min_sup=min_sup, delta=alpha,
               alpha=alpha, cfg=cfg, n_miners=n_miners, statistic=statistic)
    h2 = ph2.hist2d
    sups_grid = np.arange(n + 1)
    mask = (h2 > 0) & (sups_grid[:, None] >= min_sup)
    k = int(h2[mask].sum())
    delta = alpha / max(k, 1)
    xs, ns = np.nonzero(mask)
    pv = stat.pvalue(xs, ns, n, n_pos) if len(xs) else np.zeros(0)
    sig_mask = pv <= delta
    n_sig = int(h2[xs[sig_mask], ns[sig_mask]].sum()) if len(xs) else 0
    occ, sup, pos_sup = ph2.sig_occ, ph2.sig_sup, ph2.sig_pos_sup
    # the root closed set never rides the device buffers: append it exactly
    # when the 2-D histogram counted it as significant
    if (n >= min_sup and packed.has_labels
            and float(stat.pvalue(n, n_pos, n, n_pos)[0]) <= delta):
        occ = np.concatenate([occ, packed.occ0[None, :]], axis=0)
        sup = np.concatenate([sup, [n]])
        pos_sup = np.concatenate([pos_sup, [n_pos]])
    results = build_result_set(
        occ, sup, pos_sup, packed.db_bits, n=n, n_pos=n_pos, alpha=alpha,
        min_sup=min_sup, correction_factor=k, delta=delta, filter_host=True,
        dropped=ph2.emit_dropped, statistic=statistic, device=packed.device,
    )
    return dict(phases=(ph1, ph2), lambda_final=ph1.lam_final, min_sup=min_sup,
                correction_factor=k, delta=delta, n_significant=n_sig,
                results=results)


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


def query_diffs(a: dict, b: dict) -> list[str]:
    """Fields in which two fused23 reports differ (ResultSet included)."""
    bad = [f for f in ("lambda_final", "min_sup", "correction_factor", "delta",
                       "n_significant") if a[f] != b[f]]
    for i, (x, y) in enumerate(zip(a["phases"], b["phases"])):
        bad += [f"phase{i + 1}.{f}" for f in mine_output_diffs(x, y)]
    ra, rb = a["results"], b["results"]
    if ra != rb:
        bad.append("results")
    if ra.to_tsv() != rb.to_tsv() or ra.to_json() != rb.to_json():
        bad.append("results.export")
    return bad


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
    torch.profiler run recorded ({} when it saw no device time)."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
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


def _device_ms(fn, iters: int = 20):
    """Device time of one call of fn: all the CUDA activity the profiler
    saw over `iters` calls, over `iters` (None when it saw none)."""
    _, dev, _ = _profile(lambda: [fn() for _ in range(iters)])
    if not dev:
        return None
    return sum(us for _, us in dev.values()) / iters / 1e3


def _bound(b: int, m: int, w: int):
    """(bound_ms, bound_by): bytes over HBM vs bit operations over the
    int8 tensor rate (each input read once, S written once)."""
    ops_s = 2 * b * m * 32 * w / INT8_OPS_PER_S
    bytes_s = (m * w + b * w + b * m) * 4 / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s > bytes_s else "bytes")


def _library(occ, db):
    """(call, m_pad): one `torch._int_mm` over {0, 1} int8 operands unpacked
    beforehand, with M padded by zero items to a multiple of 8 (as the call
    requires on CUDA).  The yardstick only; the port never counts this way."""
    import torch

    from repro_torch.kernels.support_count.ref import unpack_bits_int8

    m = db.shape[0]
    m_pad = -(-m // 8) * 8
    occ_u8 = unpack_bits_int8(occ)
    db_u8 = torch.zeros((m_pad, occ_u8.shape[1]), dtype=torch.int8, device=db.device)
    db_u8[:m] = unpack_bits_int8(db)
    return (lambda: torch._int_mm(occ_u8, db_u8.t())), m_pad


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
        device_ms = (_device_ms(lambda: kernel.support_count_cuda(occ, db))
                     if prof else None)
        lib_call_ms = library_ms = m_pad = None
        if b > 16:
            lib, m_pad = _library(occ, db)
            if not torch.equal(lib()[:, :m], want):
                raise AssertionError(f"torch._int_mm != plain version at {(b, m, w)}")
            lib_call_ms = _time_ms(lib, 20 if big else 100)
            library_ms = _device_ms(lib) if prof else None
            del lib
        bound_ms, bound_by = _bound(b, m, w)
        share = bound_ms / (device_ms if device_ms is not None else ms)
        row = dict(shape=[b, m, w], mismatches=mismatches, max_abs_err=max_err,
                   ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                   library_ms=library_ms, library_call_ms=lib_call_ms,
                   library_m_pad=m_pad, bound_ms=bound_ms, bound_by=bound_by,
                   share_of_bound=share)
        rows.append(row)
        dev_txt = "" if device_ms is None else f" (device {device_ms:.4f})"
        lib_txt = ("" if lib_call_ms is None else
                   f"  library {lib_call_ms:.4f}"
                   + ("" if library_ms is None else f" (device {library_ms:.4f})")
                   + f" [M padded to {m_pad}]")
        print(f"  kernel {b:>4} x {m:>6} x {w:>3}: mismatches {mismatches} "
              f"max_abs_err {max_err}  kernel {ms:.4f}{dev_txt}  plain "
              f"{plain_ms:.4f}{lib_txt}  bound {bound_ms:.5f} ({bound_by}) "
              f"share {100 * share:.1f}%  [ms]", flush=True)
        if mismatches:
            raise AssertionError(f"kernel != plain version at {(b, m, w)}")
    return rows


def _wall(fn):
    import torch

    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


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
    from repro_torch.core.engine import EngineConfig, mine, pack_problem_from_bits
    from repro_torch.data.synthetic import paper_problem_packed
    from repro_torch.kernels.support_count import kernel

    # ---- 1. environment
    name_power = _nvidia_smi("name,power.limit")
    print(name_power, flush=True)
    clock_mhz = float(_nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    kind = torch.cuda.get_device_name(0)
    print(f"[1] card: {kind}; {props.multi_processor_count} SMs; max SM clock "
          f"{clock_mhz:.0f} MHz; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    lib = kernel.build()
    print(f"[2] built {lib.relative_to(ROOT) if lib.is_relative_to(ROOT) else lib} "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    log = kernel.build_log().strip()
    print(log, flush=True)
    if log and "0 bytes spill stores, 0 bytes spill loads" not in log:
        raise AssertionError("the kernel spills registers (see ptxas above)")

    # ---- 3. kernel vs plain version, on the card
    main_shapes = [(128, 1191, 22), (512, 1191, 22)]       # phase 4's shapes
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
    rows = check_kernel(main_shapes + full_shapes + ragged + edges,
                        profiled=len(main_shapes) + len(full_shapes))

    # ---- 4. the significance query: cuda+kernel, cuda+plain, cpu
    db_bits, labels, _, spec = paper_problem_packed("hapmap_dom_20", scale_items=0.1)
    print(f"[4] fused23 on {spec.name}: {spec.n_items} items x "
          f"{spec.n_transactions} transactions, P = 8", flush=True)
    packed = {dev: pack_problem_from_bits(db_bits, labels, n=spec.n_transactions,
                                          device=dev) for dev in ("cuda", "cpu")}

    def query(device, impl):
        cfg = EngineConfig(out_cap=4096, kernel_impl=impl)
        return fused23(packed[device], n_miners=8, cfg=cfg)

    def report(tag, rep, wall, device, impl):
        ph1, ph2 = rep["phases"]
        steps = ph1.supersteps + ph2.supersteps
        popped = int(ph1.stats["popped"].sum() + ph2.stats["popped"].sum())
        print(f"  ({tag}) {device}/{impl}: {wall:.3f} s; supersteps "
              f"{ph1.supersteps} + {ph2.supersteps} ({steps / wall:.1f}/s); "
              f"popped {popped} ({popped / wall:.0f}/s); lambda "
              f"{rep['lambda_final']}, min_sup {rep['min_sup']}, k "
              f"{rep['correction_factor']}, significant {rep['n_significant']}, "
              f"patterns {len(rep['results'])}", flush=True)
        return steps

    _wall(lambda: query("cuda", "auto"))            # warm-up, not reported
    reports = {}
    # the main path: its kernel launches are counted from 0
    kernel.launches = 0
    reports["a"], wall_a = _wall(lambda: query("cuda", "auto"))
    main_launches = kernel.launches
    steps = report("a", reports["a"], wall_a, "cuda", "auto")
    # then in turns: plain, plain, kernel; then the CPU
    for tag, device, impl in (("b", "cuda", "ref"), ("b2", "cuda", "ref"),
                              ("a2", "cuda", "auto"), ("c", "cpu", "auto")):
        reports[tag], wall = _wall(lambda: query(device, impl))
        report(tag, reports[tag], wall, device, impl)
    for tag in ("b", "b2", "a2", "c"):
        bad = query_diffs(reports["a"], reports[tag])
        if bad:
            raise AssertionError(f"query (a) != ({tag}) in {bad}")
    for f, want in QUERY_EXPECT.items():
        if reports["a"][f] != want:
            raise AssertionError(f"{f} = {reports['a'][f]}, expected {want}")
    if len(reports["a"]["results"]) != QUERY_EXPECT["n_significant"]:
        raise AssertionError("ResultSet size != n_significant")
    if main_launches <= 0:
        raise AssertionError("the main path launched no support_count kernel")
    print(f"  (a) == (b) == (c), JAX values matched; kernel launches on the "
          f"main path: {main_launches} ({main_launches / steps:.2f} per superstep)",
          flush=True)

    # where the time goes: one more warm kernel run under the profiler
    _, dev, wall_p = _profile(lambda: query("cuda", "auto"))
    if dev:
        busy = sum(us for _, us in dev.values()) / 1e6
        n_kern = sum(n for n, _ in dev.values())
        sc = sum(us for k, (_, us) in dev.items() if "support_count_kernel" in k) / 1e6
        print(f"  profile of (a): device busy {busy * 1e3:.1f} ms = "
              f"{100 * busy / wall_a:.2f}% of the unprofiled {wall_a:.3f} s "
              f"(idle {100 * (1 - busy / wall_a):.2f}%); {n_kern} device "
              f"activities ({n_kern / steps:.1f} per superstep); support_count "
              f"{sc * 1e3:.2f} ms = {100 * sc / busy:.2f}% of device time; "
              f"profiled wall {wall_p:.3f} s", flush=True)
        top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:8]
        for k, (n, us) in top:
            print(f"    {us / 1e3:9.3f} ms  {n:6d} x  {k[:100]}", flush=True)
    else:
        print("  profile of (a): the profiler saw no device time (not measured)",
              flush=True)

    # ---- 5. the paper's full widths, mode count
    print("[5] full widths, mode count, P = 8 (in turns: kernel, plain, plain, "
          "kernel; then kernel under the profiler)", flush=True)
    for name, min_sup, closed in FULL_WIDTH:
        bits, lab, _, sp = paper_problem_packed(name)
        pk = pack_problem_from_bits(bits, lab, n=sp.n_transactions, device="cuda")
        outs = {}
        for impl in ("auto", "ref", "ref", "auto"):
            cfg = EngineConfig(kernel_impl=impl, max_steps=4000)
            before = kernel.launches
            out, wall = _wall(lambda: mine(packed=pk, mode="count",
                                           min_sup=min_sup, cfg=cfg, n_miners=8))
            outs.setdefault(impl, out)
            last_wall = wall
            bad = mine_output_diffs(outs[impl], out)
            if bad:
                raise AssertionError(f"{name} ({impl}): runs differ in {bad}")
            print(f"  {name} {sp.n_items} x {sp.n_transactions} ({impl}): "
                  f"{wall:.3f} s, {out.supersteps} supersteps, closed sets "
                  f"{int(out.hist.sum())}, popped {int(out.stats['popped'].sum())}, "
                  f"kernel launches {kernel.launches - before}", flush=True)
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
        if dev:
            busy = sum(us for _, us in dev.values()) / 1e6
            sc = sum(us for k, (_, us) in dev.items()
                     if "support_count_kernel" in k) / 1e6
            print(f"  profile of {name} (kernel): device busy {busy * 1e3:.3f} ms = "
                  f"{100 * busy / last_wall:.2f}% of the last unprofiled kernel "
                  f"run's {last_wall:.3f} s (idle {100 * (1 - busy / last_wall):.2f}%); "
                  f"support_count {sc * 1e3:.3f} ms = {100 * sc / busy:.2f}% of "
                  f"device time; profiled wall {wall_p:.3f} s", flush=True)
        else:
            print(f"  profile of {name}: the profiler saw no device time "
                  "(not measured)", flush=True)

    head = rows[0]  # the main path's engine shape
    print(json.dumps({"kernels": [{
        "name": "support_count",
        "route": "cuda",
        "source": "src/repro_torch/kernels/support_count/csrc/support_count.cu",
        "replaces": "src/repro/kernels/support_count/kernel.py:45",
        "launches": main_launches,
        "mismatches": sum(r["mismatches"] for r in rows),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # the kernel's device time (profiler); call_ms is per back-to-back call
        "ms": head["device_ms"] if head["device_ms"] is not None else head["ms"],
        "call_ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        # torch._int_mm on operands unpacked beforehand, device time
        "library_ms": head["library_ms"],
        "library_m_pad": head["library_m_pad"],
        "shape": head["shape"],
        # the engine's, reconstruction's and full-width shapes (profiled)
        "shapes": [r for r in rows if r["device_ms"] is not None],
        "shapes_checked": len(rows),
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
