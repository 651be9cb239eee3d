"""One run of one cell: set-up, the measured window, the check, the result.

Three drivers, named by the traffic mix's `driver`:

- "session": one caller runs the requests back to back on one warm
  `repro_torch.api.MinerSession`, each ending in a synchronise;
- "served": a `repro_torch.serve.MiningService` of `fleet` sessions on the
  card, warmed before traffic, driven closed loop by `clients` callers,
  each submitting its next request when the last one resolved;
- "cluster": the session driver's loop as rank 0 of a gloo group of
  `processes` ranks, one to a card (`harness/cluster.py`): every rank runs
  each request in lockstep on its own session, which holds its block of
  the miners, and rank 0 times the window.

Set-up (`setup_s`) runs from the process's start to the first timed
request: imports, CUDA, loading (or first building) the kernel, making and
uploading the data, the programs of the cell's bucket and one warm request
per session.  The window then runs requests until `seconds` have passed,
lets those in flight finish, and ends at the last one's resolution.

With `trace`, the session's spans mark the profiler's timeline, and two
stretches of the window are profiled: the device alone (its idle share,
activities per superstep, the kernel's time) and then host and device
together (the idle gaps by what the host was doing).

After the window, with the program's state freed, every answer of the
window is judged against the reference (`judge.py`).
"""

from __future__ import annotations

import asyncio
import gc
import itertools
import math
import sys
import time

from . import data, judge, profile
from .cluster import Leader
from .queries import answer_of, program_query, reference_answer, warmup_spec
from .spec import Cell, load_metric
from .stats import percentile
from .tracectx import Trace

__all__ = ["run_cell"]

#: the traced run profiles from this share of the window on ...
LEAD = 0.25
#: ... the device alone for whole requests covering at least these seconds
#: (served: these seconds), then host and device together for one request
#: (served: for `HOST_PROFILE_S`)
PROFILE_S = 2.0
HOST_PROFILE_S = 0.5
#: the program's span names (`repro_torch.api.session`) besides `query:*`
#: and `phase:*`
SPAN_NAMES = ("pack", "dispatch", "postprocess", "reconstruct", "compile", "warmup")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _is_span(name: str) -> bool:
    return name.startswith(("query:", "phase:")) or name in SPAN_NAMES


class _Profiler:
    """A `torch.profiler` stretch, started and stopped by the window.

    A host stretch records a mark of the host's clock at its start, so the
    session's spans (`SpanTracer`, on `time.perf_counter_ns`) can be placed
    on the profile's timeline, whichever thread ran them.
    """

    MARK = "chipbench:clock"

    def __init__(self, device, host: bool):
        from torch.profiler import ProfilerActivity, profile as torch_profile

        acts = [ProfilerActivity.CUDA] if device.type == "cuda" else []
        if host or not acts:
            acts.append(ProfilerActivity.CPU)
        self.host = host
        self.prof = torch_profile(activities=acts)
        self.window_s = 0.0
        self._mark_ns = None

    def start(self) -> None:
        import torch

        self.prof.start()
        self._t0 = time.perf_counter()
        if self.host:
            self._mark_ns = time.perf_counter_ns()
            with torch.profiler.record_function(self.MARK):
                pass

    def stop(self, sync) -> None:
        sync()
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()

    def spans_on_timeline(self, events, epoch_ns: int) -> list[tuple]:
        """[(name, start us, end us, thread)] of Chrome-trace `events` of a
        tracer whose epoch is `epoch_ns`, in the profile's time."""
        marks = [e for e in self.prof.events() if e.name == self.MARK]
        if not marks or self._mark_ns is None:
            return []
        shift_us = (epoch_ns - self._mark_ns) / 1e3 + float(marks[0].time_range.start)
        return [(e["name"], e["ts"] + shift_us, e["ts"] + e["dur"] + shift_us, e.get("tid", 0))
                for e in events]


def _warm_profiler(device, sync) -> None:
    """Start and stop the profiler once in set-up: the first start
    initialises CUPTI, which takes seconds, and would cut into the window."""
    import torch

    p = _Profiler(device, host=True)
    p.start()
    torch.ones(1, device=device).add_(1)
    p.stop(sync)


def _sync_fn(device):
    import torch

    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def _datasets(cell: Cell, inputs, device):
    from repro_torch.api import Dataset

    out = []
    for x in inputs:
        ds = Dataset.from_packed_words(x.db_bits, x.labels, n_transactions=x.n_transactions,
                                       name=f"{cell.config['dataset']['name']}-{x.gen_seed}",
                                       device=device)
        want = cell.config.get("bucket")
        got = [ds.bucket.transactions, ds.bucket.positives, ds.bucket.items]
        if want is not None and got != list(want):
            raise RuntimeError(f"dataset {x.gen_seed} lands in bucket {got}, not {want}")
        out.append(ds)
    return out


def _runtime(cell: Cell):
    from repro_torch.api import RuntimeConfig

    return RuntimeConfig(expand_batch=int(cell.config["layout"]["expand_batch"]))


# ------------------------------------------------------------------ session
def _drive_session(cell: Cell, datasets, queries, seconds, trace, device, t_start,
                   announce=None):
    """The session driver's loop; `announce(i)`, where given, is called
    before request i runs (the warm one too), and `announce(-1)` is left
    to the caller after the window."""
    from repro_torch.api import MinerSession
    from repro_torch.kernels.support_count import kernel
    from repro_torch.obs import SpanTracer

    traffic = cell.traffic
    sync = _sync_fn(device)
    epoch_ns = time.perf_counter_ns()
    tracer = SpanTracer(torch_profiler=bool(trace))
    session = MinerSession(int(cell.config["layout"]["miners"]), device=device,
                           runtime=_runtime(cell), tracer=tracer)
    group = session.group       # a cluster rank's block of the miners, else None
    d, q = data.request(traffic, 0)
    if announce is not None:
        announce(0)
    session.run(datasets[d], queries[q])
    sync()
    if trace:
        _warm_profiler(device, sync)
    tracer.clear()
    setup_s = time.perf_counter() - t_start

    prof_dev = prof_host = None
    stage = "before"            # before -> device -> host -> after (traced runs)
    dev_start = 0
    done = []                   # (key, report, wall_s, stage)
    collective_s = []           # rank 0's seconds in the group's collectives, a request
    spans = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    for i in itertools.count():
        if time.perf_counter() >= deadline:
            break
        if trace and stage == "before" and time.perf_counter() >= t0 + LEAD * seconds:
            prof_dev = _Profiler(device, host=False)
            kernel.reset_counts()
            prof_dev.start()
            stage, dev_start = "device", len(done)
        elif trace and stage == "device" and prof_dev.window_s:
            prof_host = _Profiler(device, host=True)
            prof_host.start()
            stage = "host"
        d, q = data.request(traffic, i)
        c0 = group.seconds if group is not None else None
        t = time.perf_counter()
        if announce is not None:
            announce(i)
        report = session.run(datasets[d], queries[q])
        sync()
        t_done = time.perf_counter()
        done.append(((d, q), report, t_done - t, stage))
        if group is not None:
            collective_s.append(group.seconds - c0)
        if trace:
            spans.append(tracer.events())
        tracer.clear()
        if stage == "device" and t_done - prof_dev._t0 >= PROFILE_S:
            prof_dev.stop(sync)
            shapes = dict(kernel.launch_shapes)
        elif stage == "host":
            prof_host.stop(sync)
            stage = "after"
    t_end = time.perf_counter()
    for p in (prof_dev, prof_host):      # a stretch the window's end cut short
        if p is not None and not p.window_s:
            p.stop(sync)
    if stage == "device":
        shapes = dict(kernel.launch_shapes)

    walls = [w for _, _, w, _ in done]
    e2e = {"query_s": (t_end - t0) / len(done), "query_p95_s": percentile(walls, 95),
           "setup_s": setup_s}
    answers = [(key, rep) for key, rep, _, _ in done]
    compiled = sum(1 for _, rep, _, _ in done for p in rep.phases if not p.cache_hit)
    by_key: dict = {}
    for key, _, wall, _ in done:
        by_key.setdefault(key, []).append(round(wall, 4))
    info = dict(requests=len(done), window_s=t_end - t0, compiled_in_window=compiled,
                walls=by_key)
    tr = None
    if trace:
        tr = Trace(driver="session")
        for j, ((key, rep, wall, st), ev) in enumerate(zip(done, spans)):
            if st in ("before", "after"):
                tr.requests.append(dict(wall_s=wall, spans=ev,
                                        supersteps=sum(p.supersteps for p in rep.phases)))
                if collective_s:
                    tr.requests[-1]["collective_s"] = collective_s[j]
        if prof_dev is not None and prof_dev.window_s:
            in_dev = [rep for _, rep, _, st in done[dev_start:] if st == "device"]
            layout = cell.config["layout"]
            tr.device = dict(prof=prof_dev, launch_shapes=shapes,
                             supersteps=sum(p.supersteps for r in in_dev for p in r.phases),
                             nodes=sum(p.n_nodes for r in in_dev for p in r.phases),
                             expand_rows=int(layout["miners"]) * int(layout["expand_batch"]))
        if prof_host is not None and prof_host.window_s:
            tr.host_prof = prof_host
            tr.host_spans = [sp for (_, _, _, st), ev in zip(done, spans) if st == "host"
                             for sp in prof_host.spans_on_timeline(ev, epoch_ns)]
    del session
    return e2e, answers, 0, len(done), info, tr


def _drive_cluster(leader, cell: Cell, datasets, queries, seconds, trace, device, t_start):
    """The session driver's loop as rank 0 of the cell's group, whose
    followers `leader` started; `info` gains `ranks`, every rank's report
    (`Leader.finish`)."""
    import torch

    leader.join_group(t_start)
    out = _drive_session(cell, datasets, queries, seconds, trace, device, t_start,
                         announce=leader.announce)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    out[4]["ranks"] = leader.finish(peak)
    return out


# ------------------------------------------------------------------- served
async def _serve(cell: Cell, datasets, queries, seconds, trace, device, t_start):
    from repro_torch.obs import SpanTracer
    from repro_torch.serve import AdmissionError, MiningService, WarmupSpec

    traffic = cell.traffic
    sync = _sync_fn(device)
    statistic, pipeline = warmup_spec(cell.config)
    svc = MiningService(size=int(traffic["fleet"]), n_miners=int(cell.config["layout"]["miners"]),
                        device=device, runtime=_runtime(cell),
                        warmups=[WarmupSpec(datasets[0].bucket, statistic=statistic,
                                            pipeline=pipeline)])
    epochs = []
    for w in svc.fleet.workers:
        epochs.append(time.perf_counter_ns())
        w.session.tracer = SpanTracer(torch_profiler=bool(trace))
    await svc.start()
    warm = [data.request(traffic, i) for i in range(int(traffic["fleet"]))]
    await asyncio.gather(*[svc.mine(datasets[d], queries[q]) for d, q in warm])
    sync()
    if trace:
        _warm_profiler(device, sync)
    for w in svc.fleet.workers:
        w.session.tracer.clear()
    setup_s = time.perf_counter() - t_start

    counter = itertools.count()
    done = []                   # (key, ServeResult | None, latency_s, resolved at)
    t0 = time.perf_counter()
    deadline = t0 + seconds

    async def client():
        while time.perf_counter() < deadline:
            d, q = data.request(traffic, next(counter))
            t = time.perf_counter()
            try:
                res = await svc.mine(datasets[d], queries[q])
            except AdmissionError:
                res = None
            t_done = time.perf_counter()
            done.append(((d, q), res, t_done - t, t_done))

    profs = {}

    async def profiled():
        await asyncio.sleep(LEAD * seconds)
        for name, host, length in (("device", False, PROFILE_S), ("host", True, HOST_PROFILE_S)):
            p = _Profiler(device, host=host)
            p.start()
            await asyncio.sleep(length)
            p.stop(lambda: None)
            profs[name] = p

    tasks = [client() for _ in range(int(traffic["clients"]))]
    if trace:
        tasks.append(profiled())
    await asyncio.gather(*tasks)
    t_end = max(t for *_, t in done)
    await svc.stop()

    ok = [x for x in done if x[1] is not None and x[1].ok]
    window = t_end - t0
    lat = [x[2] if (x[1] is not None and x[1].ok) else window for x in done]
    e2e = {"served_qps": len(ok) / window, "setup_s": setup_s}
    answers = [(key, res.report) for key, res, _, _ in ok]
    cold = sum(1 for _, res, _, _ in ok if res.report.cold)
    by_key: dict = {}
    for key, _, lat_s, _ in done:
        by_key.setdefault(key, []).append(round(lat_s, 4))
    info = dict(requests=len(done), ok=len(ok), window_s=window, compiled_in_window=cold,
                walls=by_key)
    tr = None
    if trace:
        tr = Trace(driver="served")
        tr.served = [dict(ok=bool(res is not None and res.ok),
                          queued_s=res.queued_s if res is not None else None, total_s=lat_s)
                     for (_, res, _, _), lat_s in zip(done, lat)]
        if "device" in profs:
            tr.device = dict(prof=profs["device"], launch_shapes=None, supersteps=None,
                             nodes=None, expand_rows=None)
        hp = profs.get("host")
        if hp is not None:
            tr.host_prof = hp
            tr.host_spans = [sp for w, epoch in zip(svc.fleet.workers, epochs)
                             for sp in hp.spans_on_timeline(w.session.tracer.events(), epoch)]
    del svc
    return e2e, answers, len(done) - len(ok), len(done), info, tr


# ---------------------------------------------------------------- the trace
def _read_trace(cell: Cell, tr: Trace, inputs, span_names):
    """(per-layer metrics, device fields, breakdown) of a traced run."""
    x = inputs[0]
    tr.dims = dict(items=int(x.db_bits.shape[0]), words=int(x.db_bits.shape[1]),
                   transactions=int(x.n_transactions))
    device_fields, breakdown = {}, {}
    span_names = span_names | {sp[0] for sp in tr.host_spans}
    if tr.device is not None:
        p = tr.device.pop("prof")
        iv = profile.device_intervals(p.prof, span_names)
        tr.device.update(window_s=p.window_s, intervals=iv,
                         busy_s=profile.busy_union_s(iv, p.window_s))
        if tr.device["busy_s"] is not None:
            device_fields = dict(busy_s=tr.device["busy_s"], window_s=p.window_s)
        breakdown["device_ops"] = profile.top_device_ops(iv)
    hp = tr.host_prof
    if hp is not None:
        iv = profile.device_intervals(hp.prof, span_names | {hp.MARK})
        if iv:
            ops = [h for h in profile.host_events(hp.prof)
                   if h[0] not in span_names and h[0] != hp.MARK]
            breakdown["idle_gaps"] = profile.idle_gaps(iv, ops, tr.host_spans, hp.window_s)
    metrics = {}
    for m in cell.per_layer:
        value = load_metric(m["name"], cell.bench_dir)(tr)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return metrics, device_fields, breakdown


# --------------------------------------------------------------------- run
def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> tuple[dict, dict]:
    """(result line, checks) of one run of `cell` on `device`."""
    import torch

    from repro_torch.device import resolve_device

    device = resolve_device(device)
    driver = cell.traffic["driver"]
    leader = None
    if driver == "cluster":     # the followers start while this process makes its inputs
        leader = Leader(cell, seed, device)
        leader.start()
    try:
        inputs = data.make_inputs(cell.config, cell.traffic, seed)
        datasets = _datasets(cell, inputs, device)
        queries = [program_query(cell.config, p) for p in cell.traffic["params"]]
        if driver == "session":
            out = _drive_session(cell, datasets, queries, seconds, trace, device, t_start)
        elif driver == "served":
            out = asyncio.run(_serve(cell, datasets, queries, seconds, trace, device, t_start))
        elif driver == "cluster":
            out = _drive_cluster(leader, cell, datasets, queries, seconds, trace, device,
                                 t_start)
        else:
            raise ValueError(f"unknown driver {driver!r}")
    finally:
        if leader is not None:
            leader.close()
    e2e, reports, unanswered, attempted, info, tr = out
    _log(f"window: {info}")

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        # the fullest card's peak, of every rank in a cluster
        peak = max([int(torch.cuda.max_memory_allocated(device))]
                   + [r["peak"] for r in info.get("ranks", [])])
        dev = dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                   count=int(cell.chips), memory_peak_bytes=peak)
    else:
        dev = dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)

    answers = [(key, answer_of(rep)) for key, rep in reports]
    span_names = set()
    if tr is not None:
        for req in tr.requests:
            span_names.update(e["name"] for e in req["spans"] if _is_span(e["name"]))
        span_names.update(SPAN_NAMES)
    # the program's state goes before the reference runs
    del reports, datasets, out
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    metrics, breakdown = {}, {}
    if trace:
        metrics, dev_fields, breakdown = _read_trace(cell, tr, inputs, span_names)
        dev.update(dev_fields)
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}

    t_ref = time.perf_counter()
    reference = {}
    for d, q in sorted({key for key, _ in answers}):
        x = inputs[d]
        reference[(d, q)] = reference_answer(cell.config, x.dense(), x.labels,
                                             cell.traffic["params"][q])
    _log(f"reference: {len(reference)} distinct inputs in "
         f"{time.perf_counter() - t_ref:.3f} s")
    checks = judge.judge(answers, reference, unanswered, cell.config["checks"])
    wrong = checks["wrong_answers"]["value"]
    result = dict(correct=judge.passed(checks) and bool(answers), attempted=attempted,
                  failed=unanswered + wrong, metrics=metrics, device=dev)
    if trace and breakdown:
        result["breakdown"] = breakdown
    result["checks"] = checks
    if not math.isfinite(sum(v["value"] for v in metrics.values())):
        result["correct"] = False
    return result, checks
