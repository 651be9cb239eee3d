"""`repro_torch.launch.op_cost` held against the JAX package's HLO cost
parser (`repro.launch.hlo_cost.parse_hlo_costs`) on the functions of
tests/test_hlo_cost.py, at its tolerances (rel 0.01 against the
theoretical FLOPs, 0.02 for a loop of 8, 0.05 for nested loops and
against XLA), and its support-count work item and superstep op count on
the engine.

JAX's scan runs its body as one compiled loop whose trip count the parser
multiplies in; the port's loop is a Python loop whose every iteration runs
and is counted.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.core.collectives import normalize_cost_analysis  # noqa: E402
from repro.launch.hlo_cost import parse_hlo_costs  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import expand as texpand  # noqa: E402
from repro_torch.data.synthetic import SyntheticSpec, generate  # noqa: E402
from repro_torch.kernels.support_count import kernel, ops  # noqa: E402
from repro_torch.kernels.support_count.ref import support_count_ref  # noqa: E402
from repro_torch.launch.op_cost import count_costs  # noqa: E402
from repro_torch.topo.bootstrap import free_port  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_matmul_flops_match_hlo_cost():
    """The two-matmul MLP: both count 2 x 64 x 128 x 256 x 2 FLOPs."""
    @jax.jit
    def f(x, w1, w2):
        h = jnp.einsum("bd,df->bf", x, w1)
        return jnp.einsum("bf,fd->bd", jnp.tanh(h), w2)

    comp = f.lower(jax.ShapeDtypeStruct((64, 128), jnp.float32),
                   jax.ShapeDtypeStruct((128, 256), jnp.float32),
                   jax.ShapeDtypeStruct((256, 128), jnp.float32)).compile()
    want = parse_hlo_costs(comp.as_text())
    rng = np.random.default_rng(0)
    x, w1, w2 = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                 for s in ((64, 128), (128, 256), (256, 128)))
    got = count_costs(lambda: torch.einsum("bf,fd->bd",
                                           torch.tanh(torch.einsum("bd,df->bf", x, w1)), w2))
    theory = 2 * 64 * 128 * 256 * 2
    assert got["flops"] == pytest.approx(theory, rel=0.01)
    assert got["flops"] == pytest.approx(want["flops"], rel=0.05)
    assert got["flops"] == pytest.approx(
        normalize_cost_analysis(comp.cost_analysis())["flops"], rel=0.05)
    # operand + result bytes of the two products and the tanh, views free
    mm = 4 * (64 * 128 + 128 * 256 + 64 * 256) + 4 * (64 * 256 + 256 * 128 + 64 * 128)
    assert got["bytes"] == mm + 4 * 2 * 64 * 256
    assert got["coll_payload"] == {} and got["coll_link_bytes"] == 0


def test_loop_of_8_counts_every_iteration():
    N = 8

    @jax.jit
    def f(x, ws):
        y, _ = lax.scan(lambda c, w: (jnp.einsum("bd,df->bf", c, w), None), x, ws)
        return y

    comp = f.lower(jax.ShapeDtypeStruct((32, 64), jnp.float32),
                   jax.ShapeDtypeStruct((N, 64, 64), jnp.float32)).compile()
    want = parse_hlo_costs(comp.as_text())
    x, ws = torch.randn(32, 64), torch.randn(N, 64, 64)

    def loop():
        c = x
        for i in range(N):
            c = c @ ws[i]
        return c

    got = count_costs(loop)
    theory = 2 * 32 * 64 * 64 * N
    assert got["flops"] == pytest.approx(theory, rel=0.02)
    assert got["flops"] == pytest.approx(want["flops"], rel=0.02)
    assert got["by_op"]["aten.mm.default"]["count"] == N


def test_nested_loops():
    @jax.jit
    def f(x, ws):
        def outer(c, w):
            def inner(ci, _):
                return jnp.einsum("bd,df->bf", ci, w), None
            y, _ = lax.scan(inner, c, None, length=3)
            return y, None
        y, _ = lax.scan(outer, x, ws)
        return y

    comp = f.lower(jax.ShapeDtypeStruct((16, 32), jnp.float32),
                   jax.ShapeDtypeStruct((4, 32, 32), jnp.float32)).compile()
    want = parse_hlo_costs(comp.as_text())
    x, ws = torch.randn(16, 32), torch.randn(4, 32, 32)

    def nested():
        c = x
        for i in range(4):
            for _ in range(3):
                c = c @ ws[i]
        return c

    got = count_costs(nested)
    theory = 2 * 16 * 32 * 32 * 3 * 4
    assert got["flops"] == pytest.approx(theory, rel=0.05)
    assert got["flops"] == pytest.approx(want["flops"], rel=0.05)


def test_indexed_ops_and_views():
    """Views cost nothing, an indexed write twice its window, an indexed
    read twice its result, as hlo_cost charges bitcast, dynamic-update-
    slice and gather."""
    buf = torch.zeros(1000, 8)
    idx = torch.tensor([3, 7, 9])
    vals = torch.ones(3, 8)
    got = count_costs(lambda: buf.view(8000).reshape(1000, 8).t())
    assert got["bytes"] == 0 and got["ops"] >= 2
    got = count_costs(lambda: buf.index_put_((idx,), vals))
    assert got["bytes"] == 2 * vals.numel() * 4
    got = count_costs(lambda: buf[idx])
    assert got["bytes"] == 2 * 3 * 8 * 4


_JAX_ALLREDUCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, sys
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P, NamedSharding
    from repro.launch.hlo_cost import parse_hlo_costs

    mesh = jax.make_mesh((4,), ("d",))
    x = jax.ShapeDtypeStruct((128, 128), jnp.float32,
                             sharding=NamedSharding(mesh, P("d", None)))
    comp = jax.jit(lambda x: x.sum()).lower(x).compile()
    got = parse_hlo_costs(comp.as_text())
    print(json.dumps(got["coll_payload"]))
""")

_PORT_ALLREDUCE = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, "src")
    import torch, torch.distributed as dist
    rank, port = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    from repro_torch.launch.op_cost import count_costs
    shard = torch.ones(64, 128)             # this process's rows of [128, 128]

    def f():
        s = shard.sum().reshape(1)
        dist.all_reduce(s)
        return s

    got = count_costs(f)
    dist.destroy_process_group()
    print(json.dumps([got["coll_payload"], got["coll_link_bytes"]]))
""")


def test_allreduce_payload_matches_hlo_cost():
    """A sum over a [128, 128] array split across processes: the port's
    2-process gloo all-reduce carries what each of JAX's 4 devices does,
    one float32 (payloads are per process and per device), and its link
    bytes follow the ring convention, 2 (G - 1) / G payloads."""
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    jproc = subprocess.Popen([sys.executable, "-c", _JAX_ALLREDUCE], cwd=ROOT, env=env,
                             text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _PORT_ALLREDUCE, str(r), port],
                              cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for r in range(2)]
    outs = []
    try:
        for p in [jproc, *procs]:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in [jproc, *procs]:
            if p.poll() is None:
                p.kill()
                p.communicate()
    want = outs[0]
    assert want["all-reduce"] >= 4.0
    for payload, link in outs[1:]:
        assert payload == {"allreduce": want["all-reduce"]}
        assert link == pytest.approx(2 * (2 - 1) / 2 * want["all-reduce"])


# ------------------------------------------------------------------ engine
def small_problem(seed=0):
    db, labels, _ = generate(SyntheticSpec("t", 60, 48, 0.15, 16, 2, seed=seed))
    return db, labels


def _stub_cuda(monkeypatch):
    """A `cuda` path on the CPU: the engine resolves to it and the kernel's
    wrapper is the plain version."""
    monkeypatch.setattr(teng, "resolve_impl", lambda impl, device: "cuda")
    monkeypatch.setattr(kernel, "support_count_cuda",
                        lambda occ, db, blocks=None: support_count_ref(occ, db))


@pytest.mark.parametrize("mode", ["lamp1", "count2d"])
def test_support_count_item_same_under_ref_and_cuda(mode, monkeypatch):
    """One item for the root's supports (B = 1, the problem's first
    deal) and one per superstep, (M·W + B·W + B·M)·4 bytes and
    2·B·M·32W bit operations at each shape, and the same report (every op
    and byte) whether the plain version or the cuda path counts."""
    db, labels = small_problem()
    kw = {} if mode == "lamp1" else dict(min_sup=3, delta=1e-3)
    P = 8
    outs = []
    ref = count_costs(lambda: outs.append(teng.mine(db, labels, mode=mode, n_miners=P,
                                                    device="cpu", **kw)))
    steps = outs[0].supersteps
    item = ref["by_op"]["support_count"]
    B, W = P * 16, 2                       # expand_batch 16; 48 transactions
    M = 60                                 # mine() runs the exact item count

    def cost(b):
        return (M * W + b * W + b * M) * 4, 2 * b * M * 32 * W

    assert item["count"] == 1 + steps
    assert item["bytes"] == cost(1)[0] + steps * cost(B)[0]
    assert item["bit_ops"] == ref["bit_ops"] == cost(1)[1] + steps * cost(B)[1]
    _stub_cuda(monkeypatch)
    cuda = count_costs(lambda: outs.append(teng.mine(db, labels, mode=mode, n_miners=P,
                                                     device="cpu", **kw)))
    assert outs[1].supersteps == steps
    np.testing.assert_array_equal(outs[1].hist, outs[0].hist)
    assert cuda == ref


class _Bare(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts every op dispatched, the support count's own included."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode", ["lamp1", "count2d"])
def test_superstep_op_count_equals_a_run_without_the_mode(mode, monkeypatch):
    """op_cost does not perturb what it counts: a run under a bare counting
    mode, minus the ops it saw inside the support count, counts the aten
    ops op_cost counts, and both runs give the same MineOutput.  With -s
    it prints both counts per superstep."""
    db, labels = small_problem()
    kw = {} if mode == "lamp1" else dict(min_sup=3, delta=1e-3)
    outs = []
    costs = count_costs(lambda: outs.append(teng.mine(db, labels, mode=mode, n_miners=8,
                                                      device="cpu", **kw)))
    bare = _Bare()
    inside = [0]
    real = texpand.support_counts_tiled

    def counted(*a, **k):
        before = bare.n
        try:
            return real(*a, **k)
        finally:
            inside[0] += bare.n - before

    # the root's count (the first deal) and EXPAND's
    monkeypatch.setattr(teng, "support_counts_tiled", counted)
    monkeypatch.setattr(texpand, "support_counts_tiled", counted)
    with bare:
        outs.append(teng.mine(db, labels, mode=mode, n_miners=8, device="cpu", **kw))
    assert outs[1].supersteps == outs[0].supersteps
    np.testing.assert_array_equal(outs[1].hist, outs[0].hist)
    for name in outs[0].stats:
        np.testing.assert_array_equal(outs[1].stats[name], outs[0].stats[name])
    assert inside[0] > 0
    assert bare.n - inside[0] == costs["ops"]
    steps = outs[0].supersteps
    print(f"{mode}: {costs['ops'] / steps:.1f} aten ops per superstep, "
          f"{bare.n / steps:.1f} with the plain support count's own ops (P = 8)")
    assert costs == count_costs(lambda: teng.mine(db, labels, mode=mode, n_miners=8,
                                                  device="cpu", **kw))


def test_nested_support_count_is_one_item():
    """`support_counts` sweeping the plain version tile by tile is one item
    of the call's whole shape, and outside a count nothing is recorded."""
    rng = np.random.default_rng(0)
    occ = rng.integers(0, 2**32, size=(5, 3), dtype=np.uint32)
    db = rng.integers(0, 2**32, size=(300, 3), dtype=np.uint32)
    got = count_costs(lambda: ops.support_counts(occ, db, device="cpu", m_tile=64))
    item = got["by_op"]["support_count"]
    assert item["count"] == 1
    assert item["bytes"] == (300 * 3 + 5 * 3 + 5 * 300) * 4
    # outside a count the item records nothing and changes nothing
    np.testing.assert_array_equal(ops.support_counts(occ, db, device="cpu").numpy(),
                                  ops.support_counts(occ, db, device="cpu", m_tile=64).numpy())
