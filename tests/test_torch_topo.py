"""The port's topology layer (`repro_torch.topo`) held against the JAX
package's (`repro.topo`) on the CPU.

  * the machine shape and the hierarchical two-level schedule, field by
    field, over tests/test_topo.py's topologies, plus the schedule
    invariants the engine relies on;
  * the forced-topology parity: the port at forced 2x4 and 4x2 on
    tests/test_topo.py's DATA equals the JAX package's forced run on eight
    devices (a subprocess of tests/test_torch_jax_worker.py) in supersteps,
    per-miner stats, decoded traces with per-round and per-tier steal
    telemetry, and the ResultSet with P- and q-values; and equals the
    port's flat 1x8 ResultSet (the invariance of tests/test_topo.py);
  * the `--hosts 2 --devices-per-host 4` CLI blob against the JAX
    launcher's;
  * the scaling simulator against the JAX package's on one enumeration
    tree, at two points of BENCH_scaling.json's curve (the file is read,
    never written);
  * chip_smoke.py's phase-8 constants (TOPO_EXPECT), derived from the JAX
    package's forced runs of query (a) on eight devices.
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.lifeline as jlifeline  # noqa: E402
import repro.topo as jtopo  # noqa: E402
import repro.topo.simulate as jsim  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.core.lifeline as tlifeline  # noqa: E402
import repro_torch.topo as ttopo  # noqa: E402
import repro_torch.topo.simulate as tsim  # noqa: E402
from repro_torch.core.engine import EngineConfig, make_schedule  # noqa: E402
from repro_torch.data.synthetic import SyntheticSpec, generate  # noqa: E402
from repro_torch.topo.worker import main as port_worker  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from chip_smoke import TOPO_EXPECT, TRACE_ARRAYS, stats_digest  # noqa: E402
from test_torch_jax_worker import collect, spawn_jax  # noqa: E402

TOPOS = [(2, 4), (4, 8), (16, 8), (125, 8), (128, 8), (150, 8)]

#: tests/test_topo.py's DATA, as a SyntheticSpec
DATA = dict(name="topo", n_items=24, n_transactions=60, density=0.15, n_pos=20,
            n_planted=2, seed=0)
RUNTIME = dict(expand_batch=8, stack_cap=4096, steal_max=64, push_cap=256,
               out_cap=1024, kernel_impl="ref")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------- topology
def test_topology_rank_maps_match_jax():
    t, j = ttopo.Topology(3, 5), jtopo.Topology(3, 5)
    assert (t.n_proc, str(t)) == (j.n_proc, str(j)) == (15, "3x5")
    for rank in range(15):
        assert (t.host_of(rank), t.local_of(rank)) == (j.host_of(rank), j.local_of(rank))
        assert t.rank_of(t.host_of(rank), t.local_of(rank)) == rank
    for a, b in ((5, 9), (4, 5), (0, 14)):
        assert t.same_host(a, b) == j.same_host(a, b)
    for bad in (-1, 15):
        with pytest.raises(ValueError):
            t.host_of(bad)
    assert hash(ttopo.Topology(2, 4)) == hash(ttopo.Topology(2, 4))


@pytest.mark.parametrize("shape", [(0, 4), (2, -1)])
def test_topology_validates(shape):
    with pytest.raises(ValueError):
        ttopo.Topology(*shape)


def test_detect_topology_single_process():
    assert ttopo.detect_topology() == ttopo.Topology(1, 1)
    assert ttopo.detect_topology(8) == ttopo.Topology(1, 8)


# ------------------------------------------------- hierarchical schedule
@pytest.fixture(params=TOPOS, ids=[f"{h}x{d}" for h, d in TOPOS])
def schedules(request):
    h, d = request.param
    return (ttopo.Topology(h, d), ttopo.build_hierarchical_schedule(ttopo.Topology(h, d)),
            jtopo.build_hierarchical_schedule(jtopo.Topology(h, d)))


def test_schedule_matches_jax_field_by_field(schedules):
    _topo, t, j = schedules
    for f in ("n_proc", "dim", "rounds", "names", "tiers", "round_axes",
              "axis_rounds"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.factorized and t.n_rounds == j.n_rounds


@pytest.mark.parametrize("seed, n_random, cross_every", [
    (1, 4, 1), (7, 2, 3), (0, 6, 2)])
def test_schedule_options_match_jax(seed, n_random, cross_every):
    for h, d in ((2, 4), (4, 2), (8, 8), (3, 5)):
        t = ttopo.build_hierarchical_schedule(ttopo.Topology(h, d), n_random, seed,
                                              cross_every)
        j = jtopo.build_hierarchical_schedule(jtopo.Topology(h, d), n_random, seed,
                                              cross_every)
        assert (t.rounds, t.names, t.tiers, t.round_axes, t.axis_rounds) == \
            (j.rounds, j.names, j.tiers, j.round_axes, j.axis_rounds)


def test_rounds_are_pairings_on_their_tier(schedules):
    """Every round pairs distinct miners with inverse replies; local rounds
    stay on a host, cross rounds keep the local rank; the axis rounds
    expand to the global ones."""
    topo, sch, _ = schedules
    d = topo.devices_per_host
    for (req, rep), (areq, _), tier in zip(sch.rounds, sch.axis_rounds, sch.tiers):
        srcs, dsts = [s for s, _ in req], [x for _, x in req]
        assert len(set(srcs)) == len(srcs) and set(srcs) == set(dsts)
        assert set(rep) == {(x, s) for s, x in req}
        for s, x in req:
            if tier == "local":
                assert topo.same_host(s, x)
            else:
                assert not topo.same_host(s, x)
                assert topo.local_of(s) == topo.local_of(x)
        want = ({(h * d + a, h * d + b) for h in range(topo.n_hosts) for a, b in areq}
                if tier == "local" else
                {(g * d + ll, k * d + ll) for g, k in areq for ll in range(d)})
        assert set(req) == want


def test_lifeline_union_connects_the_whole_machine(schedules):
    topo, sch, _ = schedules
    adj = {i: set() for i in range(topo.n_proc)}
    for req, _rep in sch.rounds:
        for s, x in req:
            adj[s].add(x)
            adj[x].add(s)
    reach, frontier = {0}, [0]
    while frontier:
        nxt = adj[frontier.pop()] - reach
        reach |= nxt
        frontier.extend(nxt)
    assert reach == set(range(topo.n_proc))


def test_degenerate_shapes_match_jax():
    for shape in ((1, 1), (1, 3), (5, 1)):
        t = ttopo.build_hierarchical_schedule(ttopo.Topology(*shape))
        j = jtopo.build_hierarchical_schedule(jtopo.Topology(*shape))
        assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
            {f: getattr(j, f) for f in j.__dataclass_fields__}
    one = ttopo.build_hierarchical_schedule(ttopo.Topology(1, 1))
    assert one.rounds == (((), ()),) and one.names == ("loc_noop",)
    # H == 1: the local tier is the flat schedule over one host
    assert ttopo.build_hierarchical_schedule(ttopo.Topology(1, 8)).rounds == \
        tlifeline.build_schedule(8).rounds == jlifeline.build_schedule(8).rounds


def test_engine_schedule_follows_the_topology():
    flat = make_schedule(EngineConfig(), 8)
    assert flat.tiers is None and flat.rounds == tlifeline.build_schedule(8).rounds
    hier = make_schedule(EngineConfig(topology=ttopo.Topology(4, 2)), 8)
    assert hier.rounds == jtopo.build_hierarchical_schedule(jtopo.Topology(4, 2)).rounds


def test_topology_mismatch_raises_the_jax_error():
    import jax

    from repro.core.engine import EngineConfig as JEngineConfig
    from repro.core.engine import make_mesh_and_schedule

    with pytest.raises(ValueError) as jerr:
        make_mesh_and_schedule(JEngineConfig(topology=jtopo.Topology(2, 4)),
                               jax.devices()[:1])
    with pytest.raises(ValueError) as terr:
        tapi.MinerSession(1, device="cpu", runtime=tapi.RuntimeConfig(
            topology=ttopo.Topology(2, 4)))
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="topology 2x4 needs 8"):
        make_schedule(EngineConfig(topology=ttopo.Topology(2, 4)), 4)


# ------------------------------------------------ forced-topology parity
def _phase_view(phases):
    return [(p["supersteps"], p["stats"], p["steal_by_round"], p["tier_fairness"])
            for p in phases]


def test_forced_topologies_equal_jax_and_the_flat_run():
    """Forced 2x4 and 4x2 on one process, traced every superstep: the JAX
    package's forced runs on eight devices, bit for bit, and the flat 1x8
    run's ResultSet."""
    runtime = dict(RUNTIME, trace_period=1)
    shapes = ((2, 4), (4, 2))
    procs = {s: spawn_jax(dict(dataset=DATA, runtime=dict(runtime, topology=list(s))), 8)
             for s in shapes}
    flat = port_worker(dict(dataset=DATA, device="cpu", n_miners=8, runtime=runtime,
                            results_json=True))
    for shape in shapes:
        session = tapi.MinerSession(8, device="cpu", runtime=tapi.RuntimeConfig(
            **runtime, topology=ttopo.Topology(*shape)))
        ds = tapi.Dataset.from_dense(*generate(SyntheticSpec(**DATA))[:2],
                                     name="topo", device="cpu")
        rep = session.run(ds, tapi.SignificantPatternQuery(alpha=0.05))
        want = collect(procs[shape])
        assert want["n_devices"] == 8
        assert rep.results.to_json() == want["results_json"] == flat["results_json"]
        assert [p.supersteps for p in rep.phases] == \
            [p["supersteps"] for p in want["phases"]]
        for ph, jph in zip(rep.phases, want["phases"]):
            assert {k: v.tolist() for k, v in ph.output.stats.items()} == jph["stats"]
            assert ph.steal_by_round == jph["steal_by_round"]
            assert ph.tier_fairness == jph["tier_fairness"]
            assert set(ph.tier_fairness) == {"local", "cross"}
            for f in TRACE_ARRAYS:
                assert np.asarray(getattr(ph.trace, f)).tolist() == jph["trace"][f], f
        # the traced hierarchical run attributes steals to both tiers
        tiers = {v["tier"] for ph in rep.phases for v in ph.steal_by_round.values()
                 if v["donated"]}
        assert tiers == {"local", "cross"}


def test_cli_forced_topology_blob_matches_jax(tmp_path):
    flags = ["--problem", "hapmap_dom_10", "--scale-items", "0.005", "--hosts", "2",
             "--devices-per-host", "4", "--pipeline", "fused23", "--trace-period", "1"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    procs = {
        who: subprocess.Popen(
            [sys.executable, "-m", mod, *flags, "--json-out", str(tmp_path / f"{who}.json"),
             *extra], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for who, mod, extra in (("jax", "repro.launch.mine", []),
                                ("port", "repro_torch.launch.mine", ["--device", "cpu"]))}
    for who, p in procs.items():
        try:
            _, err = p.communicate(timeout=300)
        finally:
            if p.poll() is None:
                p.kill()
                p.communicate()
        assert p.returncode == 0, f"{who}:\n{err[-4000:]}"
    blobs = {who: json.loads((tmp_path / f"{who}.json").read_text()) for who in procs}
    for b in blobs.values():
        b.pop("wall_s")
    assert blobs["port"] == blobs["jax"]
    assert len(blobs["port"]["per_device_popped"]) == 8
    tiers = {v["tier"] for v in blobs["port"]["superstep_trace"]["steal_by_round"].values()}
    assert tiers == {"local", "cross"}


def test_cli_rejects_a_half_topology():
    from repro_torch.launch.mine import main

    with pytest.raises(SystemExit):
        main(["--hosts", "2", "--device", "cpu"])
    with pytest.raises(SystemExit):
        main(["--hosts", "2", "--devices-per-host", "4", "--devices", "6",
              "--device", "cpu"])


# ------------------------------------------------------------- simulator
def test_extract_tree_matches_jax():
    rng = np.random.default_rng(7)
    db = rng.random((120, 30)) < 0.3
    assert tsim.extract_tree(db, min_sup=4).children == \
        jsim.extract_tree(db, min_sup=4).children


def test_cost_model_matches_jax():
    for h, d in ((1, 1), (1, 8), (4, 1), (4, 8), (8, 8)):
        t, j = ttopo.Topology(h, d), jtopo.Topology(h, d)
        assert tsim.sync_cost(t) == jsim.sync_cost(j)
        assert tsim.round_costs(ttopo.build_hierarchical_schedule(t), t) == \
            jsim.round_costs(jtopo.build_hierarchical_schedule(j), j)
        assert tsim.round_costs(tlifeline.build_schedule(h * d), t) == \
            jsim.round_costs(jlifeline.build_schedule(h * d), j)


def test_simulator_reproduces_bench_scaling():
    """BENCH_scaling.json's tree, and its P = 8 and P = 64 points: both
    packages' simulators agree field by field and give the file's numbers."""
    with open(os.path.join(ROOT, "BENCH_scaling.json")) as f:
        bench = json.load(f)
    db, _, _ = generate(SyntheticSpec(name="scaling", **bench["dataset"]))
    tree = tsim.extract_tree(db, min_sup=bench["min_sup"])
    assert tree.n_nodes == bench["tree_nodes"]
    jtree = jsim.Tree(children=tree.children)
    base = tsim.simulate_mine(tree, tlifeline.build_schedule(1), ttopo.Topology(1, 1),
                              steal_enabled=False)
    assert round(base.makespan_s, 6) == bench["t1_modeled_s"]
    dph = bench["devices_per_host"]
    for point in bench["curve"][:2]:
        p = point["P"]
        shape = (max(p // dph, 1), min(p, dph))
        t, j = ttopo.Topology(*shape), jtopo.Topology(*shape)
        assert str(t) == point["topology"]
        runs = {
            "hierarchical": (ttopo.build_hierarchical_schedule(t),
                             jtopo.build_hierarchical_schedule(j), True),
            "flat": (tlifeline.build_schedule(p), jlifeline.build_schedule(p), True),
            "naive_static": (tlifeline.build_schedule(p), jlifeline.build_schedule(p),
                             False),
        }
        for name, (tsch, jsch, steal) in runs.items():
            got = tsim.simulate_mine(tree, tsch, t, steal_enabled=steal)
            want = jsim.simulate_mine(jtree, jsch, j, steal_enabled=steal)
            assert got.__dict__ == want.__dict__, (p, name)
            assert got.supersteps == point["supersteps"][name]
            assert round(base.makespan_s / got.makespan_s, 2) == point["speedup"][name]
            if name != "naive_static":
                assert got.steals == point["steals"][name]
                assert round(got.cross_round_s * 1e3, 3) == point["cross_round_ms"][name]


# ------------------------------------------------ chip_smoke.py constants
def test_chip_smoke_topology_constants_are_jax_values():
    """Phase 8a's TOPO_EXPECT: query (a) on eight JAX devices at forced 2x4
    and 4x2, traced every superstep — supersteps, the digest of every
    phase's per-miner stats, and the steal volume donated in each named
    round; the ResultSet is query (a)'s."""
    from chip_smoke import QUERY_EXPECT

    data = {"paper": "hapmap_dom_20", "scale_items": 0.1}
    (pipeline, statistic), expect = QUERY_EXPECT["a"]
    procs = {tag: spawn_jax(dict(dataset=data,
                                 query=dict(pipeline=pipeline, statistic=statistic),
                                 runtime=dict(trace_period=1, topology=want["shape"])), 8)
             for tag, want in TOPO_EXPECT.items()}
    for tag, want in TOPO_EXPECT.items():
        out = collect(procs[tag])
        assert (hashlib.sha256(out["results_json"].encode()).hexdigest()[:16]
                == expect["results_sha256"])
        assert [p["supersteps"] for p in out["phases"]] == want["supersteps"]
        assert [stats_digest(p["stats"]) for p in out["phases"]] == want["stats_sha256"]
        assert [{k: v["donated"] for k, v in p["steal_by_round"].items()}
                for p in out["phases"]] == want["donated_by_round"]
