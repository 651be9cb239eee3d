"""The port's BSP engine (repro_torch.core.engine) held against the JAX
engine (repro.core.engine), both on the CPU.

Both packages mine the very same bits: the JAX PackedProblem's arrays go
through `repro_torch.core.engine.packed_from_numpy`.  Everything integer is
compared exactly — histograms, lambda, supersteps, per-miner stats and the
emitted pattern records.  One stated tolerance: a record is emitted when
its float32 device P-value clears the gate, and torch's float32 `lgamma`
differs from JAX's `gammaln` in the last bits, so a record whose float64
P-value lies within 1e-2 relative of the gate may be emitted by one engine
and not the other; the tests assert that only such records differ.

P = 1 runs in-process; P = 8 runs the JAX side in a subprocess with eight
simulated devices (tests/engine_subproc_main.py, unchanged).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core.lifeline import build_schedule as jax_build_schedule  # noqa: E402
from repro.data.synthetic import SyntheticSpec, generate  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.lifeline import build_schedule  # noqa: E402
from repro_torch.stats import fisher_pvalue  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: float64 P-values this close (relative) to the emission gate may be
#: decided differently by the two float32 device tests
GATE_RTOL = 1e-2

KW = dict(expand_batch=4, stack_cap=512, steal_max=16, push_cap=8, out_cap=1024)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    torch's default of one thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_problem(seed, n_items=60, n_transactions=48, n_pos=16):
    spec = SyntheticSpec("t", n_items, n_transactions, 0.15, n_pos, 2, seed=seed)
    db, labels, _ = generate(spec)
    return db, labels


def port_packed(jp, device="cpu"):
    return teng.packed_from_numpy(
        tiles=jp.layout.tiles, m=jp.m, pos_mask=jp.pos_mask, occ0=jp.occ0,
        n=jp.n, n_pos=jp.n_pos, n_pad=jp.n_pad, npos_pad=jp.npos_pad,
        m_pad=jp.m_pad, has_labels=jp.has_labels, device=device,
    )


def assert_records_match(a, b, *, gate, n, n_pos):
    """Emitted records equal in order, except records near the gate."""
    def far(out):
        p = fisher_pvalue(out.sig_sup, out.sig_pos_sup, n, n_pos)
        return np.abs(p - gate) > GATE_RTOL * gate

    ka, kb = far(a), far(b)
    for f in ("sig_occ", "sig_core", "sig_sup", "sig_pos_sup"):
        np.testing.assert_array_equal(getattr(a, f)[ka], getattr(b, f)[kb], err_msg=f)
    assert a.sig_count - b.sig_count == int((~ka).sum() - (~kb).sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["lamp1", "count", "count2d", "test"])
def test_mode_matches_jax_p1(mode, seed):
    db, labels = small_problem(seed)
    jp = jeng.pack_problem(db, labels)
    extra = {"lamp1": {}, "count": dict(min_sup=3),
             "count2d": dict(min_sup=3, delta=0.05),
             "test": dict(min_sup=3, delta=0.01)}[mode]
    a = jeng.mine(None, packed=jp, mode=mode,
                  cfg=jeng.EngineConfig(kernel_impl="ref", **KW),
                  devices=jax.devices()[:1], **extra)
    b = teng.mine(packed=port_packed(jp), mode=mode, cfg=teng.EngineConfig(**KW),
                  n_miners=1, **extra)
    np.testing.assert_array_equal(a.hist, b.hist)
    assert (a.lam_final, a.supersteps) == (b.lam_final, b.supersteps)
    assert set(a.stats) == set(b.stats)
    for name in a.stats:
        np.testing.assert_array_equal(a.stats[name], b.stats[name], err_msg=name)
    assert b.stats["pushed"].sum() > 0
    if mode in ("count2d", "test"):
        assert_records_match(a, b, gate=extra["delta"], n=jp.n, n_pos=jp.n_pos)
        assert len(b.sig_occ) > 0
    if mode == "count2d":
        np.testing.assert_array_equal(a.hist2d, b.hist2d)


def test_resume_and_emit_overflow_paths():
    """A push cap of 2 forces resume nodes and a 4-record buffer overflows:
    both engines take the same paths (and warn about the dropped records)."""
    db, labels = small_problem(5, n_items=40)
    jp = jeng.pack_problem(db, labels)
    kw = dict(KW, push_cap=2, out_cap=4)
    with pytest.warns(RuntimeWarning, match="emission overflow"):
        a = jeng.mine(None, packed=jp, mode="count2d", min_sup=2, delta=0.05,
                      cfg=jeng.EngineConfig(kernel_impl="ref", **kw),
                      devices=jax.devices()[:1])
    with pytest.warns(RuntimeWarning, match="emission overflow"):
        b = teng.mine(packed=port_packed(jp), mode="count2d", min_sup=2,
                      delta=0.05, cfg=teng.EngineConfig(**kw))
    np.testing.assert_array_equal(a.hist2d, b.hist2d)
    for name in a.stats:
        np.testing.assert_array_equal(a.stats[name], b.stats[name], err_msg=name)
    assert b.emit_dropped > 0 and b.stats["pushed"].sum() > 0


def test_pack_and_deal_match_jax():
    """Packing with program padding, the root deal and the Tarone table are
    the JAX package's, array for array."""
    db, labels = small_problem(3, n_items=70, n_transactions=50)
    jp = jeng.pack_problem(db, labels, n_pad=64, npos_pad=32, m_pad=96, m_tile=32)
    tp = teng.pack_problem(db, labels, n_pad=64, npos_pad=32, m_pad=96, m_tile=32,
                           device="cpu")
    np.testing.assert_array_equal(tp.layout.tiles, jp.layout.tiles)
    np.testing.assert_array_equal(tp.pos_mask, jp.pos_mask)
    np.testing.assert_array_equal(tp.occ0, jp.occ0)
    for f in ("n", "n_pos", "m", "n_pad", "npos_pad", "m_pad", "has_labels"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.db_dev.shape == jp.layout.tiles.shape
    for n_proc in (1, 3):
        want = jeng.deal_roots(jp, n_proc, jeng.EngineConfig(stack_cap=64), 2)
        got = teng.deal_roots(tp, n_proc, 64, 2)
        for x, y in zip(want, got):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        teng._thresholds_int(50, 17, 0.05), jeng._thresholds_int(50, 17, 0.05)
    )


def test_unported_options_raise():
    db, labels = small_problem(0)
    for kw, match in ((dict(trace_period=1, trace_cap=8), "queue 1, item 7"),
                      (dict(ckpt_period=4), "queue 1, item 8"),
                      (dict(topology=object()), "queue 1, item 10")):
        with pytest.raises(NotImplementedError, match=match):
            teng.mine(db, labels, mode="count", min_sup=3,
                      cfg=teng.EngineConfig(**kw), device="cpu")


# ------------------------------------------------------------------ P = 8
@pytest.mark.parametrize("n_proc", [1, 2, 3, 8, 12])
def test_schedule_equals_jax(n_proc):
    """The same seed draws the same lifeline rounds in both packages."""
    a = jax_build_schedule(n_proc, 4, seed=3)
    b = build_schedule(n_proc, 4, seed=3)
    assert (a.n_proc, a.dim, a.rounds, a.names) == (b.n_proc, b.dim, b.rounds, b.names)


def run_subproc(spec: dict) -> dict:
    from repro.core.collectives import host_device_count_env

    env = host_device_count_env(spec["n_devices"])
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "engine_subproc_main.py"), json.dumps(spec)],
        capture_output=True, text=True, env=env, timeout=900,
    )
    assert out.returncode == 0, f"stderr:\n{out.stderr[-4000:]}"
    return json.loads(out.stdout.strip().splitlines()[-1])


#: engine_subproc_main.py's EngineConfig for a spec without overrides
SUBPROC_KW = dict(expand_batch=8, stack_cap=4096, steal_max=64, push_cap=256,
                  out_cap=1024)
PROB = dict(n_items=24, n_transactions=60, density=0.15, n_pos=20)


def subproc_problem(seed):
    db, labels, _ = generate(SyntheticSpec("sub", PROB["n_items"],
                                           PROB["n_transactions"], PROB["density"],
                                           PROB["n_pos"], 2, seed=seed))
    return db, labels


@pytest.mark.slow
def test_count_p8_matches_jax_subprocess():
    got = run_subproc(dict(PROB, seed=0, mode="count", min_sup=3, n_devices=8))
    db, labels = subproc_problem(0)
    out = teng.mine(db, labels, mode="count", min_sup=3,
                    cfg=teng.EngineConfig(**SUBPROC_KW), n_miners=8, device="cpu")
    assert out.hist.tolist() == got["hist"]
    assert out.supersteps == got["supersteps"]
    assert out.stats["closed"].tolist() == got["closed_per_dev"]
    assert out.stats["steals_got"].tolist() == got["steals_got"]
    assert out.stats["gives"].tolist() == got["gives"]
    assert sum(got["steals_got"]) > 0, "P = 8 must exercise steals"


@pytest.mark.slow
def test_fused23_p8_matches_jax_subprocess():
    """The port's fused23 staging (repro_torch.api, exact buckets as the JAX
    `lamp_distributed` shim uses) at P = 8 against JAX on eight simulated
    devices."""
    from repro_torch.api import (
        EXACT_BUCKETS,
        Dataset,
        MinerSession,
        RuntimeConfig,
        SignificantPatternQuery,
    )

    got = run_subproc(dict(PROB, seed=1, mode="lamp_full", pipeline="fused23",
                           n_devices=8))
    db, labels = subproc_problem(1)
    ds = Dataset.from_dense(db, labels, bucket_policy=EXACT_BUCKETS, device="cpu")
    session = MinerSession(8, device="cpu", runtime=RuntimeConfig.from_engine_config(
        teng.EngineConfig(**SUBPROC_KW)))
    rep = session.run(ds, SignificantPatternQuery(pipeline="fused23"))
    ph1, ph2 = (p.output for p in rep.phases)
    assert rep.lambda_final == got["lambda_final"]
    assert rep.min_sup == got["min_sup"]
    assert rep.correction_factor == got["correction_factor"]
    assert rep.delta == got["delta"]
    assert rep.n_significant == got["n_significant"]
    assert ph1.supersteps == got["p1_supersteps"]
    assert ph1.stats["steals_got"].tolist() == got["steals_got"]
    assert ph2.stats["closed"].tolist() == got["closed_per_dev"]
    assert ph2.stats["popped"].tolist() == got["popped_per_dev"]
    patterns = [[list(p.items), p.support, p.pos_support, p.pvalue, p.qvalue]
                for p in rep.results]
    assert patterns == got["patterns"]
    assert rep.results.complete == got["patterns_complete"]
    assert sum(got["steals_got"]) > 0
