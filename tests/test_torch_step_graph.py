"""The superstep replayed as one CUDA graph (`repro_torch.core.engine.
_StepGraph`) held against the eager superstep loop, bit for bit.

On the CPU: the device step counter chooses the steal round and the lambda
sync exactly as the host's step count does; the eager loop is taken where
a graph cannot serve; the kernel's launch counters count a captured launch
at each replay; and the graph path's buffers (the program's own carry,
operands copied in before every run, the step counter, the census) run
every session query as the eager loop does, with a stand-in capture whose
replay reruns the captured superstep.  On a card (marker `cuda`): the
same queries with real graphs, their launches counted alike, and a run on
a stream of its own (a fleet worker's) replaying none.  This file
imports nothing of JAX: the eager loop is the reference (it is held to the
JAX package in tests/test_torch_engine.py and tests/test_torch_api.py).
"""

import copy
import threading
from collections import Counter
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import (  # noqa: E402
    ClosedFrequentQuery,
    Dataset,
    MinerSession,
    RuntimeConfig,
    SignificantPatternQuery,
)
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.global_sync import build_global_sync, hunger_census  # noqa: E402
from repro_torch.core.lifeline import build_schedule  # noqa: E402
from repro_torch.core.steal import build_steal_round  # noqa: E402
from repro_torch.data.synthetic import SyntheticSpec, generate  # noqa: E402
from repro_torch.kernels.support_count import kernel  # noqa: E402
from repro_torch.launch import op_cost  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    torch's default of one thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- the step counter
def random_carry(rng, P, cap, w, nb):
    """A lamp1 carry's fields that STEAL and GLOBAL touch, some miners
    hungry, the histograms past their last sync."""
    sp = np.where(rng.random(P) < 0.4, 0, rng.integers(1, cap, P))
    hist_snap = rng.integers(0, 40, (P, nb))
    return SimpleNamespace(
        occ_stack=torch.from_numpy(rng.integers(0, 2**31, (P, cap + 1, w)).astype(np.int32)),
        meta=torch.from_numpy(rng.integers(0, 1000, (P, cap + 1, 4)).astype(np.int32)),
        sp=torch.from_numpy(sp.astype(np.int64)),
        head=torch.from_numpy(rng.integers(0, cap, P)),
        hist=torch.from_numpy(hist_snap + rng.integers(0, 40, (P, nb))),
        hist_snap=torch.from_numpy(hist_snap),
        g_hist_acc=torch.from_numpy(rng.integers(0, 400, nb)),
        lam=torch.tensor(2, dtype=torch.int64),
    )


@pytest.mark.parametrize("P", [8, 5])
def test_device_step_counter_moves_the_carry_as_the_host_step(P):
    """For every t of two full cycles of R rounds x sync_period steps, STEAL
    and GLOBAL at a 0-d device step counter (the CUDA graph's) move the
    carry exactly as at the host's step t: the same round's requesters
    and repliers, the same lambda sync on the same steps."""
    sync_period, cap, w, n, n_pos = 4, 64, 3, 200, 60
    cfg = SimpleNamespace(steal_max=16)
    schedule = build_schedule(P, 4, 0)
    R = schedule.n_rounds
    steal = build_steal_round(schedule, cfg, stack_cap=cap, device="cpu")
    sync = build_global_sync(mode="lamp1", sync_period=sync_period)
    thr = torch.from_numpy(teng._thresholds_int(n, n_pos, 0.05).astype(np.int64))
    synced = gave = 0
    for t in range(2 * R * sync_period):
        start = random_carry(np.random.default_rng(t), P, cap, w, n + 2)
        host, dev = copy.deepcopy(start), copy.deepcopy(start)
        t_dev = torch.tensor(t, dtype=torch.int64)
        got_host = steal(t, hunger_census(host.sp), host)
        got_dev = steal(t_dev, hunger_census(dev.sp), dev)
        sync(t, host, thr)
        sync(t_dev, dev, thr)
        assert int(t_dev) == t
        for a, b in zip(got_host, got_dev):
            assert torch.equal(a, b), t
        for name, a in vars(host).items():
            assert torch.equal(a, getattr(dev, name)), (t, name)
        synced += not torch.equal(host.g_hist_acc, start.g_hist_acc)
        gave += int(got_host[1].sum())
    assert synced == 2 * R   # (t + 1) % sync_period == 0, and only there
    assert gave > 0


def test_a_device_step_is_refused_where_processes_join_in():
    """A round or a sync that calls collectives needs the host's step."""
    group = SimpleNamespace(lo=0, hi=2, n_local=2)
    steal = build_steal_round(build_schedule(4, 4, 0), SimpleNamespace(steal_max=4),
                              stack_cap=8, device="cpu", group=group)
    st = random_carry(np.random.default_rng(0), 2, 8, 1, 4)
    with pytest.raises(ValueError, match="host's step"):
        steal(torch.tensor(0), hunger_census(torch.zeros(4, dtype=torch.int64)), st)
    sync = build_global_sync(mode="lamp1", sync_period=1, group=group)
    with pytest.raises(ValueError, match="host's step"):
        sync(torch.tensor(0), st, torch.zeros(4, dtype=torch.int64))


# ------------------------------------------------------- path selection
def test_eager_loop_only_where_a_graph_cannot_serve():
    """A graph on a card in one process with the trace ring off; the eager
    loop on the CPU, with a group, with the trace ring on, and while
    op_cost counts (it sees only the operators it dispatches); a fleet
    worker's own stream is the card's case (see the `cuda` test below)."""
    cfg = teng.EngineConfig()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert teng.step_graphs(cuda, None, cfg)
    assert not teng.step_graphs(cpu, None, cfg)
    assert not teng.step_graphs(cuda, object(), cfg)
    assert not teng.step_graphs(cuda, None, replace(cfg, trace_period=2, trace_cap=4))
    assert teng.on_default_stream(cpu)
    ds = datasets(cpu)[0]
    for ckpt in (0, 3):
        session = MinerSession(2, device=cpu, runtime=RuntimeConfig(ckpt_period=ckpt))
        session.run(ds, ClosedFrequentQuery(min_sup=5))
        m = session.metrics
        assert m.counter("miner_superstep_replays_total").value == 0
        assert m.counter("miner_superstep_graphs_total").value == 0
        for entry in session._programs.values():
            g = entry.compiled.step_graph
            assert g.graph is None and g.carry is None and g.replays == 0
    seen = []
    assert not op_cost.counting()
    op_cost.count_costs(lambda: seen.append(op_cost.counting()))
    assert seen == [True] and not op_cost.counting()


# ------------------------------------------------------- the step leaves
@pytest.mark.parametrize("mode", ["lamp1", "count", "test", "count2d"])
def test_a_superstep_writes_only_the_step_leaves(mode):
    """The eager superstep, run on a shallow copy of a pass's carry (three
    times, each on a copy of the last), rebinds or changes only leaves
    `CARRY_LEAVES` marks as written by a step: the leaves a graph replay
    keeps at fixed addresses.  Outside
    that set are only the trace ring and the host ints `t` and `work`."""
    assert set(teng.CARRY_FIELDS) - set(teng.STEP_FIELDS) == {"trace", "t", "work"}
    db, labels, _ = generate(SyntheticSpec("leaves", 40, 60, 0.3, 20, 2, seed=1))
    packed = teng.pack_problem(db, labels, device="cpu")
    P = 5
    cfg = teng.EngineConfig(expand_batch=2, stack_cap=256, steal_max=4, push_cap=64,
                            out_cap=64, sync_period=1)
    deal, ctx = teng.make_phase_args(packed, n_proc=P, cfg=cfg, stack_cap=cfg.stack_cap,
                                     mode=mode, alpha=0.5, min_sup=2, delta=0.5)
    program = teng.build_mine_step(
        n=packed.n_pad, n_pos=packed.npos_pad, m=packed.m_pad, cfg=cfg,
        stack_cap=cfg.stack_cap, schedule=build_schedule(P, 4, 0), mode=mode,
        device="cpu")
    carry = program.start(deal, packed, ctx)
    written = set()
    for t in range(1, 4):   # the roots' closed sets are counted a step late
        before = {k: getattr(carry, k).clone() for k in teng.CARRY_FIELDS
                  if isinstance(getattr(carry, k), torch.Tensor)}
        view = copy.copy(carry)
        assert program(view, t) is view and view.t == t
        written |= {k for k, x in before.items()
                    if getattr(view, k) is not getattr(carry, k)
                    or not torch.equal(getattr(carry, k), x)}
        carry = view
    assert written <= set(teng.STEP_FIELDS)
    # the steps did work: they popped, counted and pushed on every mode's path
    assert {"occ_stack", "meta", "sp", "hist", "stats"} <= written
    assert ({"lamp1": {"hist_snap", "g_hist_acc"}, "count": set(),
             "test": {"out_occ", "out_meta", "out_ptr", "n_sig"},
             "count2d": {"hist2d", "out_occ", "out_meta", "out_ptr"}}[mode]
            <= written)


# ------------------------------------------------------- launch counters
def test_captured_launches_count_at_each_replay():
    """A capture records this thread's launches instead of counting them
    (another thread's still count); each replay counts them once."""
    shape, tile = (1024, 512, 512), (16, 64, 32)
    kernel.reset_counts()
    try:
        with kernel.recording_launches() as rec:
            kernel._count_launch(shape, tile)
            kernel._count_launch(shape, tile)
            other = threading.Thread(target=kernel._count_launch,
                                     args=((1, 512, 512), tile))
            other.start()
            other.join(timeout=10)
            assert not other.is_alive()
        assert rec == Counter({(shape, tile): 2})
        assert kernel.launches == 1 and dict(kernel.launch_shapes) == {(1, 512, 512): 1}
        for _ in range(3):
            kernel.count_replayed(rec)
        assert kernel.launches == 7
        assert kernel.launch_shapes[shape] == 6
        assert kernel.launch_tiles[(*shape, tile)] == 6
        kernel._count_launch(shape, tile)   # the recording has ended
        assert kernel.launches == 8
    finally:
        kernel.reset_counts()


# ------------------------------------------------------- whole queries
def datasets(device):
    """Two datasets of one shape bucket with other N and N_pos: a graph
    that kept the first one's would answer the second wrongly."""
    out = []
    for seed, (m, n, n_pos) in enumerate([(60, 48, 14), (52, 58, 15)]):
        db, labels, _ = generate(SyntheticSpec(f"g{seed}", m, n, 0.2, n_pos, 2, seed=seed))
        out.append(Dataset.from_dense(db, labels, name=f"g{seed}", device=device))
    assert out[0].bucket == out[1].bucket
    return out


QUERIES = [
    SignificantPatternQuery(alpha=0.05, pipeline="three_phase"),
    SignificantPatternQuery(alpha=0.2, pipeline="three_phase"),
    SignificantPatternQuery(alpha=0.05, pipeline="fused23", statistic="chi2"),
    SignificantPatternQuery(alpha=0.1, pipeline="fused23"),
    ClosedFrequentQuery(min_sup=5),
]


def output_fields(out):
    """Every array and number of a MineOutput but the packed DB."""
    got = {k: v for k, v in vars(out).items() if k not in ("db_bits", "stats", "trace")}
    got.update({f"stats.{k}": v for k, v in out.stats.items()})
    return got


def assert_same_report(a, b):
    assert a.results.to_json() == b.results.to_json()
    assert (a.lambda_final, a.min_sup, a.correction_factor, a.n_significant) == (
        b.lambda_final, b.min_sup, b.correction_factor, b.n_significant)
    assert len(a.phases) == len(b.phases)
    for pa, pb in zip(a.phases, b.phases):
        assert (pa.mode, pa.supersteps, pa.lam_final) == (pb.mode, pb.supersteps, pb.lam_final)
        fa, fb = output_fields(pa.output), output_fields(pb.output)
        assert fa.keys() == fb.keys()
        for k in fa:
            if isinstance(fa[k], np.ndarray):
                np.testing.assert_array_equal(fa[k], fb[k], err_msg=f"{pa.mode} {k}")
            else:
                assert fa[k] == fb[k], (pa.mode, k)


def run_all(device, ckpt_period, graphs, monkeypatch):
    """Every query on both datasets, twice, on one session; the eager loop
    unless `graphs`.  Returns (reports, launches by shape, the session)."""
    with monkeypatch.context() as mp:
        if not graphs:
            mp.setattr(teng, "step_graphs", lambda device, group, cfg: False)
        session = MinerSession(4, device=device,
                               runtime=RuntimeConfig(expand_batch=4, ckpt_period=ckpt_period))
        kernel.reset_counts()
        reports = [session.run(ds, q) for _ in range(2)
                   for ds in datasets(device) for q in QUERIES]
    return reports, Counter(kernel.launch_shapes), session


def replay_share(session, reports):
    m = session.metrics
    steps = sum(p.supersteps for r in reports for p in r.phases)
    return (m.counter("miner_superstep_replays_total").value,
            m.counter("miner_superstep_graphs_total").value, steps)


def check_graph_path(device, ckpt_period, monkeypatch):
    eager, eager_launches, _ = run_all(device, ckpt_period, False, monkeypatch)
    graph, graph_launches, session = run_all(device, ckpt_period, True, monkeypatch)
    for a, b in zip(eager, graph):
        assert_same_report(a, b)
    assert graph_launches == eager_launches
    replays, graphs, steps = replay_share(session, graph)
    programs = session.cache_info().n_programs
    # lamp1, count, test (Fisher and none), count2d (Fisher and chi2)
    assert graphs == programs == 6
    # each program's first superstep runs eagerly, every other one replays
    assert replays == steps - programs > 0.8 * steps
    return graph


@pytest.mark.parametrize("ckpt_period", [0, 3])
def test_graph_path_on_the_cpu_equals_the_eager_loop(ckpt_period, monkeypatch):
    """The graph path's buffers on the CPU, with a stand-in capture whose
    replay reruns the captured superstep on them: every query, on two
    datasets of one bucket and at several alphas, classic and segmented,
    equals the eager loop's answer bit for bit."""
    def capture(self, body):
        def replay():
            view = copy.copy(self.carry)
            self.census.copy_(body(view))
            teng._rebound_back(self.carry, view)

        self.graph, self.launches = SimpleNamespace(replay=replay), Counter()
        self.graphs += 1

    monkeypatch.setattr(teng, "step_graphs",
                        lambda device, group, cfg: group is None and cfg.trace_period == 0)
    monkeypatch.setattr(teng._StepGraph, "_capture", capture)
    check_graph_path("cpu", ckpt_period, monkeypatch)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("ckpt_period", [0, 3])
def test_cuda_graph_equals_the_eager_loop(ckpt_period, monkeypatch):
    """On the card: closed, lamp1, count, test and count2d programs, classic
    and segmented, replaying CUDA graphs, answer every query on two
    datasets of one bucket and at several alphas as the eager loop does,
    bit for bit, and launch the kernel as often at each shape."""
    _need_card()
    check_graph_path("cuda", ckpt_period, monkeypatch)


@pytest.mark.cuda
def test_cuda_a_run_off_the_default_stream_replays_no_graph():
    """A session run on a stream of its own, as a serving fleet's worker
    runs, takes the eager loop (a replay there deadlocks with a profiler
    stopped from another thread) and answers as on the default stream."""
    _need_card()
    ds = datasets("cuda")[0]
    query = SignificantPatternQuery(alpha=0.05, pipeline="fused23")
    on_default = MinerSession(4, device="cuda", runtime=RuntimeConfig(expand_batch=4))
    want = on_default.run(ds, query)
    own = MinerSession(4, device="cuda", runtime=RuntimeConfig(expand_batch=4))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        assert not teng.on_default_stream(torch.device("cuda"))
        got = [own.run(ds, query) for _ in range(2)]
    stream.synchronize()
    for rep in got:
        assert_same_report(want, rep)
    replays, graphs, _ = replay_share(own, got)
    assert replays == graphs == 0
    assert replay_share(on_default, [want])[1] > 0
