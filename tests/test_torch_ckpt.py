"""The port's checkpoints (repro_torch.ckpt) held against the JAX package's
(repro.ckpt), on the CPU.

* the step format, as tests/test_ckpt.py checks it: view dtypes round-trip,
  prune, junk dirs, a crash before publish, corruption fallback;
* the same bytes: a frontier written by the port and by JAX has equal
  manifests and equal `arrays.npz` entries, step for step, at P = 1 and at
  P = 8 (the JAX side in a subprocess with eight simulated devices,
  tests/test_torch_jax_worker.py); `dataset_fingerprint` agrees;
* frontiers cross: a frontier written by JAX and resumed by the port gives
  JAX's ResultSet, and the reverse.

Exact equality is the tolerance throughout.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import ml_dtypes  # noqa: E402

import repro.api as japi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.ckpt import mining as jmining  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.data.synthetic import SyntheticSpec, generate  # noqa: E402
from repro.testing import faults as jfaults  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.ckpt import mining  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    FaultPlan,
    SimulatedFault,
    corrupt_step_dir,
    injected,
)
from test_torch_jax_worker import run_jax  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    torch's default of one thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves_equal(a, b) -> bool:
    ka, kb = ckpt._flatten(a), ckpt._flatten(b)
    if ka.keys() != kb.keys():
        return False
    for k in ka:
        x, y = ka[k], kb[k]
        if isinstance(x, torch.Tensor) != isinstance(y, torch.Tensor):
            return False
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or not torch.equal(x, y):
                return False
        elif np.asarray(x).dtype != np.asarray(y).dtype or not np.array_equal(x, y):
            return False
    return True


# ---------------------------------------------------------------- format
def test_roundtrip_view_as_dtypes(tmp_path):
    """bf16/fp8 leaves ride npz as integer views and come back bit-exact,
    as torch tensors of their dtype."""
    tree = {
        "bf16": torch.arange(8, dtype=torch.bfloat16) / 3,
        "e4m3": torch.full((4,), 1.5).to(torch.float8_e4m3fn),
        "e5m2": torch.full((3,), 0.25).to(torch.float8_e5m2),
        "f32": np.linspace(0, 1, 5, dtype=np.float32),
        "i32": np.int32(11),
        "nested": [torch.ones(2, dtype=torch.int64), None, {"b": np.zeros(3, np.uint32)}],
    }
    ckpt.save(tree, str(tmp_path), 3, meta={"tag": "v"})
    restored, manifest = ckpt.restore(str(tmp_path), 3, tree)
    assert manifest["meta"]["tag"] == "v"
    assert leaves_equal(tree, restored)
    assert restored["nested"][1] is None
    data, _ = ckpt.load_step(str(tmp_path), 3)
    assert data["bf16"].dtype == torch.bfloat16
    assert data["e4m3"].dtype == torch.float8_e4m3fn
    on_dev, _ = ckpt.restore(str(tmp_path), 3, tree, device="cpu")
    assert isinstance(on_dev["f32"], torch.Tensor) and on_dev["f32"].dtype == torch.float32


def test_steps_cross_between_packages(tmp_path):
    """A step either package writes, the other reads: same leaf names,
    manifests and stored bytes, bf16 and fp8 included."""
    port_tree = {"bf16": torch.arange(8, dtype=torch.bfloat16) / 3,
                 "e4m3": torch.full((4,), 1.5).to(torch.float8_e4m3fn),
                 "w": [np.arange(6, dtype=np.float32), {"z": np.int32(4), "a": None}]}
    jax_tree = {"bf16": np.asarray(port_tree["bf16"].float().numpy(), ml_dtypes.bfloat16),
                "e4m3": np.full(4, 1.5, ml_dtypes.float8_e4m3fn),
                "w": [np.arange(6, dtype=np.float32), {"z": np.int32(4), "a": None}]}
    ckpt.save(port_tree, str(tmp_path / "port"), 1, meta={"k": 1})
    jckpt.save(jax_tree, str(tmp_path / "jax"), 1, meta={"k": 1})
    assert ((tmp_path / "port/step_1/manifest.json").read_text()
            == (tmp_path / "jax/step_1/manifest.json").read_text())
    a = np.load(tmp_path / "port/step_1/arrays.npz")
    b = np.load(tmp_path / "jax/step_1/arrays.npz")
    assert a.files == b.files == ["bf16", "e4m3", "w::0", "w::1::z"]
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    got, _ = ckpt.restore(str(tmp_path / "jax"), 1, port_tree)
    assert leaves_equal(got, port_tree)
    back, _ = jckpt.restore(str(tmp_path / "port"), 1, jax_tree)
    assert back["bf16"].dtype == ml_dtypes.bfloat16
    assert back["bf16"].view(np.uint16).tobytes() == jax_tree["bf16"].view(np.uint16).tobytes()


def test_prune_and_junk_dirs(tmp_path):
    tree = {"w": np.zeros(2)}
    for s in range(1, 6):
        ckpt.save(tree, str(tmp_path / "p"), s, keep=3)
    assert ckpt.list_steps(str(tmp_path / "p")) == [3, 4, 5]
    d = tmp_path / "j"
    ckpt.save(tree, str(d), 7)
    os.makedirs(d / ".tmp_step_9")
    os.makedirs(d / ".old_step_7")
    os.makedirs(d / "step_8")          # no manifest inside
    os.makedirs(d / "step_x")
    (d / "notes.txt").write_text("hi")
    assert ckpt.list_steps(str(d)) == [7]
    assert ckpt.latest_step(str(d)) == 7


def test_restore_missing_leaf_and_shape_mismatch(tmp_path):
    ckpt.save({"a": np.zeros(3)}, str(tmp_path), 1)
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(str(tmp_path), 1, {"a": np.zeros(3), "b": np.zeros(2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), 1, {"a": torch.zeros(4)})


def test_crash_before_publish_keeps_old_step(tmp_path):
    """A writer killed between staging and publishing leaves the previous
    step untouched and restorable."""
    tree1, tree2 = {"w": np.full(3, 1.0)}, {"w": np.full(3, 2.0)}
    ckpt.save(tree1, str(tmp_path), 5)
    with injected(FaultPlan(die_in_ckpt_write=0)):
        with pytest.raises(SimulatedFault):
            ckpt.save(tree2, str(tmp_path), 5)
    restored, _ = ckpt.restore(str(tmp_path), 5, tree1)
    assert leaves_equal(tree1, restored)
    assert ckpt.list_steps(str(tmp_path)) == [5]
    ckpt.save(tree2, str(tmp_path), 5)
    restored, _ = ckpt.restore(str(tmp_path), 5, tree1)
    assert leaves_equal(tree2, restored)


def test_corruption_detected_and_restore_latest_falls_back(tmp_path):
    tree_a = {"w": np.arange(64, dtype=np.float32)}
    tree_b = {"w": np.arange(64, dtype=np.float32) * 2}
    ckpt.save(tree_a, str(tmp_path), 1, keep=5)
    ckpt.save(tree_b, str(tmp_path), 2, keep=5)
    corrupt_step_dir(str(tmp_path / "step_2"))
    with pytest.raises(ckpt.CorruptCheckpoint):
        ckpt.load_step(str(tmp_path), 2)
    with pytest.warns(RuntimeWarning, match="skipping corrupt"):
        restored, manifest = ckpt.restore_latest(str(tmp_path), tree_a)
    assert manifest["step"] == 1
    assert leaves_equal(tree_a, restored)
    assert ckpt.restore_latest(str(tmp_path / "empty"), tree_a) == (None, None)


# -------------------------------------------------------------- frontiers
def problem(seed=1, n=60, m=24):
    spec = SyntheticSpec(name=f"ck{seed}", n_items=m, n_transactions=n, density=0.15,
                         n_pos=20, n_planted=2, seed=seed)
    return spec, *generate(spec)[:2]


def assert_same_steps(dir_a, dir_b):
    """Two checkpoint trees hold the same steps, manifests and arrays."""
    phases = sorted(os.listdir(dir_a))
    assert phases == sorted(os.listdir(dir_b)) and phases
    n = 0
    for ph in phases:
        steps = sorted(os.listdir(os.path.join(dir_a, ph)))
        assert steps == sorted(os.listdir(os.path.join(dir_b, ph)))
        for st in steps:
            pa, pb = os.path.join(dir_a, ph, st), os.path.join(dir_b, ph, st)
            with open(os.path.join(pa, "manifest.json")) as f, \
                    open(os.path.join(pb, "manifest.json")) as g:
                assert f.read() == g.read(), (ph, st)
            za, zb = np.load(os.path.join(pa, "arrays.npz")), np.load(
                os.path.join(pb, "arrays.npz"))
            assert za.files == zb.files == sorted(teng.CARRY_FIELDS)
            for k in za.files:
                assert za[k].dtype == zb[k].dtype, (ph, st, k)
                assert za[k].tobytes() == zb[k].tobytes(), (ph, st, k)
            n += 1
    return n


@pytest.mark.parametrize("mode, extra", [("lamp1", {}), ("count2d", dict(min_sup=3,
                                                                         delta=0.05))])
def test_engine_frontiers_byte_equal_p1(mode, extra, tmp_path):
    _, db, labels = problem()
    jp = jeng.pack_problem(db, labels)
    tp = teng.packed_from_numpy(
        tiles=jp.layout.tiles, m=jp.m, pos_mask=jp.pos_mask, occ0=jp.occ0, n=jp.n,
        n_pos=jp.n_pos, n_pad=jp.n_pad, npos_pad=jp.npos_pad, m_pad=jp.m_pad,
        has_labels=jp.has_labels, device="cpu")
    kw = dict(expand_batch=4, stack_cap=512, steal_max=16, push_cap=8, ckpt_period=1)
    jeng.mine(None, packed=jp, mode=mode, cfg=jeng.EngineConfig(kernel_impl="ref", **kw),
              devices=jax.devices()[:1], ckpt_dir=str(tmp_path / "jax" / "x"),
              ckpt_keep=1000, **extra)
    teng.mine(packed=tp, mode=mode, cfg=teng.EngineConfig(**kw),
              ckpt_dir=str(tmp_path / "port" / "x"), ckpt_keep=1000, **extra)
    assert assert_same_steps(tmp_path / "jax", tmp_path / "port") > 5
    assert mining.dataset_fingerprint(tp) == jmining.dataset_fingerprint(jp)


@pytest.mark.parametrize("policy", ["default", "exact"])
def test_dataset_fingerprint_equal(policy):
    _, db, labels = problem(seed=2)
    kw = {} if policy == "default" else dict(bucket_policy=japi.EXACT_BUCKETS)
    jds = japi.Dataset.from_dense(db, labels, **kw)
    kw = {} if policy == "default" else dict(bucket_policy=tapi.EXACT_BUCKETS)
    tds = tapi.Dataset.from_dense(db, labels, device="cpu", **kw)
    assert mining.dataset_fingerprint(tds.packed) == jmining.dataset_fingerprint(jds.packed)
    prov = dict(mode="lamp1", statistic="fisher", alpha=0.05, start_sup=1, delta=0.0)
    assert mining.make_provenance(tds.packed, **prov) == jmining.make_provenance(
        jds.packed, **prov)


RT = dict(expand_batch=4, ckpt_period=2)


@pytest.mark.parametrize("pipeline", ["fused23", "three_phase"])
def test_frontiers_cross_between_packages_p1(pipeline, tmp_path):
    """Killed in one package, resumed in the other: JAX's ResultSet."""
    _, db, labels = problem(seed=1)
    jds = japi.Dataset.from_dense(db, labels, name="ck1")
    tds = tapi.Dataset.from_dense(db, labels, name="ck1", device="cpu")
    jq, tq = (japi.SignificantPatternQuery(pipeline=pipeline),
              tapi.SignificantPatternQuery(pipeline=pipeline))

    def jsession():
        return japi.MinerSession(jax.devices()[:1], runtime=japi.RuntimeConfig(**RT))

    def tsession():
        return tapi.MinerSession(1, device="cpu", runtime=tapi.RuntimeConfig(**RT))

    want = jsession().run(jds, jq).results.to_json()
    with jfaults.injected(jfaults.FaultPlan(die_after_segments=3)):
        with pytest.raises(jfaults.SimulatedFault):
            jsession().run(jds, jq, ckpt_dir=str(tmp_path / "jax"))
    got = tsession().run(tds, tq, resume_from=str(tmp_path / "jax"))
    assert any(p.resumed for p in got.phases)
    assert got.results.to_json() == want
    with injected(FaultPlan(die_after_segments=3)):
        with pytest.raises(SimulatedFault):
            tsession().run(tds, tq, ckpt_dir=str(tmp_path / "port"))
    back = jsession().run(jds, jq, resume_from=str(tmp_path / "port"))
    assert any(p.resumed for p in back.phases)
    assert back.results.to_json() == want


def test_frontiers_byte_equal_and_cross_p8(tmp_path):
    """P = 8: the checkpoints of an uninterrupted fused23 query are the JAX
    package's byte for byte; a JAX frontier killed two segments in resumes
    in the port, and a port frontier resumes in JAX, both to JAX's answer."""
    spec, db, labels = problem(seed=5, n=100, m=32)
    data = dict(name=spec.name, n_items=spec.n_items, n_transactions=spec.n_transactions,
                density=spec.density, n_pos=spec.n_pos, n_planted=spec.n_planted,
                seed=spec.seed)
    job = dict(dataset=data, runtime=RT, query=dict(pipeline="fused23"))
    full = run_jax(dict(job, ckpt_dir=str(tmp_path / "jax_full")), 8)
    killed = run_jax(dict(job, ckpt_dir=str(tmp_path / "jax_kill"),
                          die_after_segments=2), 8)
    assert "killed" in killed
    tds = tapi.Dataset.from_dense(db, labels, name=spec.name, device="cpu")
    q = tapi.SignificantPatternQuery(pipeline="fused23")

    def tsession():
        return tapi.MinerSession(8, device="cpu", runtime=tapi.RuntimeConfig(**RT))

    rep = tsession().run(tds, q, ckpt_dir=str(tmp_path / "port_full"))
    assert rep.results.to_json() == full["results_json"]
    assert [p.ckpt_bytes for p in rep.phases] == [p["ckpt_bytes"] for p in full["phases"]]
    assert assert_same_steps(tmp_path / "jax_full", tmp_path / "port_full") >= 2
    resumed = tsession().run(tds, q, resume_from=str(tmp_path / "jax_kill"))
    assert resumed.phases[0].resumed
    assert resumed.results.to_json() == full["results_json"]
    with injected(FaultPlan(die_after_segments=2)):
        with pytest.raises(SimulatedFault):
            tsession().run(tds, q, ckpt_dir=str(tmp_path / "port_kill"))
    back = run_jax(dict(job, resume_from=str(tmp_path / "port_kill")), 8)
    assert back["phases"][0]["resumed"]
    assert back["results_json"] == full["results_json"]
    assert json.loads(full["results_json"])["patterns"]
