"""The port's miner dim across processes (`repro_torch.core.collectives`,
`repro_torch.topo.bootstrap`) on the CPU: a gloo cluster of 2 processes x
4 miners equals the one-process 8-miner port run and the JAX package's
flat 8-device run (tests/test_topo.py's multi-process oracle, held by the
port), and a segmented pass across processes is refused as JAX refuses it.

Each cluster runs `repro_torch/topo/worker.py` in two fresh processes, with
a timeout of its own, so a hang fails one test instead of the run.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.api as tapi  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.collectives import MinerGroup, process_group  # noqa: E402
from repro_torch.topo import Topology, bootstrap  # noqa: E402
from repro_torch.topo.worker import WORKER  # noqa: E402
from repro_torch.topo.worker import main as port_worker  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
JAX_HARNESS = os.path.join(HERE, "topo_subproc_main.py")

#: tests/test_topo.py's DATA
DATA = dict(name="topo", n_items=24, n_transactions=60, density=0.15, n_pos=20,
            n_planted=2, seed=0)
RUNTIME = dict(expand_batch=8, stack_cap=4096, steal_max=64, push_cap=256,
               out_cap=1024, kernel_impl="ref")
ENV = dict(os.environ, OMP_NUM_THREADS="1")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_flat8():
    """tests/topo_subproc_main.py standalone: the JAX flat 8-device run."""
    spec = dict(n_items=DATA["n_items"], n_transactions=DATA["n_transactions"],
                density=DATA["density"], n_pos=DATA["n_pos"], alpha=0.05,
                n_devices=8, topology="flat")
    return subprocess.Popen([sys.executable, JAX_HARNESS, json.dumps(spec)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=dict(ENV, JAX_PLATFORMS="cpu"))


def _collect(proc, timeout=300):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


def _patterns(results_json):
    """A ResultSet export as tests/topo_subproc_main.py lists patterns."""
    return [[list(p["items"]), p["support"], p["pos_support"], p["pvalue"], p["qvalue"]]
            for p in json.loads(results_json)["patterns"]]


def test_cluster_2x4_equals_one_process_and_jax_flat():
    """Two gloo processes of 4 miners under the hierarchical 2x4 schedule,
    traced: both processes return the one-process forced-2x4 run's report
    (supersteps, per-miner stats, per-round and per-tier steal telemetry,
    the ResultSet), whose patterns are the flat runs' — the port's 1x8 and
    the JAX package's on eight devices — P- and q-values included."""
    jax_flat = _jax_flat8()
    runtime = dict(RUNTIME, trace_period=1)
    spec = dict(dataset=DATA, device="cpu", topology="hier", runtime=runtime,
                results_json=True)
    cluster = bootstrap.launch_local_cluster(
        WORKER, spec, n_processes=2, miners_per_process=4, timeout=300, env=ENV,
        all_processes=True)
    one = port_worker(dict(spec, n_miners=8, topology=[2, 4]))
    flat = port_worker(dict(spec, n_miners=8, topology="flat"))
    for rank, out in enumerate(cluster):
        assert (out["process_id"], out["num_processes"], out["miners_here"]) == (rank, 2, 4)
        assert out["collectives"]["calls"] > 0
        for k in ("lambda_final", "min_sup", "correction_factor", "delta",
                  "n_significant", "results_json", "phases"):
            assert out[k] == one[k], k
    assert one["results_json"] == flat["results_json"]
    assert {v["tier"] for p in one["phases"] for v in p["steal_by_round"].values()
            if v["donated"]} == {"local", "cross"}
    want = _collect(jax_flat)
    assert want["n_devices_global"] == 8
    assert _patterns(one["results_json"]) == want["patterns"]
    assert (one["lambda_final"], one["min_sup"], one["correction_factor"],
            one["delta"], one["n_significant"]) == (
        want["lambda_final"], want["min_sup"], want["correction_factor"],
        want["delta"], want["n_significant"])


def test_flat_cluster_equals_the_one_process_flat_run():
    """The flat schedule across two processes: most of its random rounds
    pair miners of different processes, so nearly every steal goes
    through the exchange; the cluster is bit-identical to one process."""
    spec = dict(dataset=DATA, device="cpu", topology="flat", runtime=RUNTIME,
                query=dict(pipeline="fused23"), results_json=True)
    out = bootstrap.launch_local_cluster(
        WORKER, spec, n_processes=2, miners_per_process=4, timeout=300, env=ENV)
    one = port_worker(dict(spec, n_miners=8))
    assert out["phases"] == one["phases"]
    assert out["results_json"] == one["results_json"]
    assert sum(sum(p["stats"]["steals_got"]) for p in one["phases"]) > 0


def test_multiprocess_segmented_pass_is_refused_as_in_jax():
    session = tapi.MinerSession(8, device="cpu", runtime=tapi.RuntimeConfig(
        **RUNTIME, ckpt_period=4, topology=Topology(2, 4)))
    # process 0 of a two-process group: refused before any collective
    session.group = MinerGroup(8, rank=0, world=2)
    ds = tapi.Dataset.from_dense(*_data(), name="topo", device="cpu")
    with pytest.raises(NotImplementedError, match="multi-process mesh"):
        session.run(ds, tapi.SignificantPatternQuery(alpha=0.05))


def _data():
    from repro_torch.data.synthetic import SyntheticSpec, generate

    db, labels, _ = generate(SyntheticSpec(**DATA))
    return db, labels


def test_single_process_has_no_group():
    assert process_group(8) is None
    assert tapi.MinerSession(8, device="cpu").group is None


def _deal(n_miners):
    """A pass's root deal for DATA and the packed problem."""
    ds = tapi.Dataset.from_dense(*_data(), name="topo", device="cpu")
    cfg = engine.EngineConfig(**RUNTIME)
    deal, _ = engine.make_phase_args(
        ds.packed, n_proc=n_miners, cfg=cfg, stack_cap=cfg.stack_cap,
        mode="count", alpha=0.05, min_sup=2, delta=0.0)
    return deal, ds.packed


def _stacks(deal, packed):
    carry = engine._Carry(deal=deal, db_tiles=packed.db_dev, lam0=2,
                          **engine.carry_dims(packed.n_pad, packed.npos_pad, "count"),
                          out_cap=4, trace_cap=0, device=packed.device)
    return carry.to_fields(("occ_stack", "meta", "sp"))


def test_miner_group_blocks():
    g = MinerGroup(8, rank=1, world=2)
    assert (g.n_local, g.lo, g.hi) == (4, 4, 8)
    whole, _ = _deal(8)
    deal = whole.miners(g.lo, g.hi)
    assert deal.n_proc == 4 and deal.sp.tolist() == whole.sp[4:].tolist()
    assert sorted(set(deal.meta[:, 0] % 8)) == [4, 5, 6, 7]
    assert deal.miner.tolist() == (deal.meta[:, 0] % 8 - 4).tolist()
    assert deal.stack_cap == whole.stack_cap and deal.occ0 is whole.occ0
    with pytest.raises(ValueError, match="split evenly"):
        MinerGroup(6, rank=0, world=4)
    with pytest.raises(ValueError):
        MinerGroup(8, rank=2, world=2)


@pytest.mark.parametrize("world", [2, 4, 8])
def test_local_deal_gives_the_rows_of_the_global_stacks(world):
    """Each process's stacks, built from its block of the compact deal,
    are its miners' rows [lo, hi) of the global [P, CAP, W] stacks."""
    deal, packed = _deal(8)
    whole = _stacks(deal, packed)
    assert whole["sp"].sum() == deal.n_roots > 0
    for rank in range(world):
        g = MinerGroup(8, rank=rank, world=world)
        local = _stacks(deal.miners(g.lo, g.hi), packed)
        for key in ("occ_stack", "meta", "sp"):
            np.testing.assert_array_equal(local[key], whole[key][g.lo:g.hi],
                                          err_msg=f"{key} rank {rank}")


def _harness(tmp_path, body):
    path = tmp_path / "harness.py"
    path.write_text(textwrap.dedent("""
        import json, sys, time
        spec = json.loads(sys.argv[1])
    """) + textwrap.dedent(body))
    return str(path)


def test_launcher_returns_every_process_answer(tmp_path):
    harness = _harness(tmp_path, """
        print("noise")
        print(json.dumps({"pid": spec["process_id"], "n": spec["n_miners"],
                          "world": spec["num_processes"]}))
    """)
    spec = {"device": "cpu"}
    outs = bootstrap.launch_local_cluster(harness, spec, n_processes=3,
                                          miners_per_process=2, timeout=60,
                                          all_processes=True)
    assert outs == [{"pid": i, "n": 6, "world": 3} for i in range(3)]
    assert bootstrap.launch_local_cluster(harness, spec, n_processes=2,
                                          miners_per_process=1,
                                          timeout=60) == {"pid": 0, "n": 2, "world": 2}


def test_launcher_kills_the_cluster_when_a_rank_dies(tmp_path):
    """Rank 1 fails at once; rank 0 would wait for it forever (as in gloo):
    the launcher kills it and raises with both processes' stderr."""
    harness = _harness(tmp_path, """
        if spec["process_id"] == 1:
            sys.exit("rank 1 gave up")
        time.sleep(600)
    """)
    with pytest.raises(RuntimeError, match="rank 1 gave up"):
        bootstrap.launch_local_cluster(harness, {"device": "cpu"}, n_processes=2,
                                       miners_per_process=1, timeout=120)


def test_launcher_times_out(tmp_path):
    harness = _harness(tmp_path, "time.sleep(600)\n")
    with pytest.raises(RuntimeError, match="timed out"):
        bootstrap.launch_local_cluster(harness, {"device": "cpu"}, n_processes=2,
                                       miners_per_process=1, timeout=1)
