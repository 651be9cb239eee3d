"""The port's support-count dispatch (repro_torch.kernels.support_count) held
against the JAX package's (repro.kernels.support_count.ops).

Popcount sums are exact integers, so every comparison is bit-exact.  On the
CPU the port runs its plain PyTorch version; the CUDA kernel cases (marked
`cuda`) run only where a card is present (chip_smoke.py holds the kernel
against the plain version at the engine's shapes on the card).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.bitmap import (  # noqa: E402
    BitmapLayout,
    popcount32,
    supports_np,
    words_to_tensor,
)
from repro_torch.kernels.support_count import kernel, ops  # noqa: E402
from repro_torch.kernels.support_count.ref import (  # noqa: E402
    support_count_ref,
    unpack_bits_int8,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    torch's default of one thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_support_counts(occ, db):
    """The JAX package's dispatch, imported at use: the card's machine has no
    JAX, and the `cuda` cases there must still collect."""
    from repro.kernels.support_count.ops import support_counts

    return support_counts(occ, db)


def rand_words(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


def port_counts(occ, db, **kw):
    return ops.support_counts(occ, db, device="cpu", **kw).numpy()


@pytest.mark.parametrize("b", [1, 3, 8, 17])
@pytest.mark.parametrize("m", [1, 5, 512, 700])
@pytest.mark.parametrize("w", [1, 7, 32, 40])
def test_shape_sweep_vs_jax(b, m, w):
    """The port's plain version == the JAX dispatch at ragged shapes (the
    sweep of tests/test_kernel_support_count.py)."""
    rng = np.random.default_rng(b * 1000 + m * 10 + w)
    occ = rand_words(rng, (b, w))
    db = rand_words(rng, (m, w))
    want = np.asarray(jax_support_counts(occ, db))
    got = port_counts(occ, db)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m_tile", [1, 64, 100, 128])
def test_tiled_vs_untiled(m_tile):
    """Sweeping the item axis in tiles changes nothing, whether m is below,
    at, or astride a tile boundary."""
    rng = np.random.default_rng(m_tile)
    for b, m, w in [(3, 1, 2), (5, 64, 9), (9, 257, 12), (2, 300, 1)]:
        occ = rand_words(rng, (b, w))
        db = rand_words(rng, (m, w))
        np.testing.assert_array_equal(
            port_counts(occ, db, m_tile=m_tile), supports_np(occ, db)
        )


def test_tiled_entry_over_layout():
    """support_counts_tiled (the engine's entry) over a BitmapLayout: the
    padded tail items report zero support."""
    rng = np.random.default_rng(7)
    m, w = 150, 4
    db = rand_words(rng, (m, w))
    layout = BitmapLayout.from_db_bits(db, m_tile=64)  # m_pad = 192
    occ = rand_words(rng, (5, w))
    got = ops.support_counts_tiled(
        words_to_tensor(occ, "cpu"), words_to_tensor(layout.tiles, "cpu"), impl="ref"
    ).numpy()
    assert got.shape == (5, layout.m_pad)
    np.testing.assert_array_equal(got[:, :m], supports_np(occ, db))
    assert (got[:, m:] == 0).all()


def test_high_bit_and_all_ones_words():
    """Words with the top bit set are negative as int32: the popcount must
    still count 32 bits of them (an arithmetic shift would smear the sign)."""
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0xAAAAAAAA,
                      0x55555555, 0xF0F0F0F0, 0x80000001], dtype=np.uint32)
    got = popcount32(words_to_tensor(words, "cpu")).numpy()
    np.testing.assert_array_equal(got, np.bitwise_count(words))
    occ = np.full((4, 23), 0xFFFFFFFF, dtype=np.uint32)
    occ[1] = 0x80000000
    db = np.full((9, 23), 0xFFFFFFFF, dtype=np.uint32)
    db[3] = 0x80000001
    want = supports_np(occ, db)
    assert want[0, 0] == 23 * 32
    np.testing.assert_array_equal(port_counts(occ, db), want)
    np.testing.assert_array_equal(np.asarray(jax_support_counts(occ, db)), want)


def test_resolve_impl_and_no_fallback():
    assert ops.resolve_impl("auto", "cpu") == "ref"
    assert ops.resolve_impl("auto", "cuda") == "cuda"
    assert ops.resolve_impl("ref", "cuda") == "ref"
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.resolve_impl("cuda", "cpu")
    with pytest.raises(ValueError, match="unknown kernel impl"):
        ops.resolve_impl("pallas", "cpu")
    # the kernel's wrapper refuses CPU tensors instead of computing on them
    occ = torch.zeros((2, 3), dtype=torch.int32)
    before = kernel.launches
    with pytest.raises(ValueError, match="not CUDA"):
        kernel.support_count_cuda(occ, occ)
    assert kernel.launches == before


@pytest.mark.parametrize("w", [1, 7, 8, 9, 23])
def test_int_mm_over_unpacked_bits(w):
    """The library yardstick chip_smoke.py times: {0, 1} int8 rows from
    `unpack_bits_int8`, one `torch._int_mm` (B > 16, M a multiple of 8, as
    the call needs on CUDA) == the plain version == the JAX dispatch."""
    rng = np.random.default_rng(w)
    occ = rand_words(rng, (24, w))
    db = rand_words(rng, (40, w))
    occ[0] = 0xFFFFFFFF
    occ[1, 0] = 0x80000000
    db[3] = 0xFFFFFFFF
    occ_t, db_t = words_to_tensor(occ, "cpu"), words_to_tensor(db, "cpu")
    bits = unpack_bits_int8(db_t)
    assert bits.dtype == torch.int8 and bits.shape == (40, 32 * w)
    want_bits = np.unpackbits(db.view(np.uint8), axis=1, bitorder="little")
    np.testing.assert_array_equal(bits.numpy(), want_bits)
    got = torch._int_mm(unpack_bits_int8(occ_t), bits.t())
    assert got.dtype == torch.int32
    assert torch.equal(got, support_count_ref(occ_t, db_t))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_support_counts(occ, db)))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
def test_cuda_kernel_matches_ref():
    """The CUDA kernel == the plain version, bit for bit (needs a card), at
    the MMA kernel's edges: one and two 16-row fragments and a second row
    block (B), a tile of 64 items and astride one (M; 4100 takes the
    16-byte store path), W at, past and twice the 8-word K step, and past
    the widest resident width (400: staged in K chunks)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(1, 1, 1), (7, 4095, 23), (33, 4097, 400), (128, 1191, 22)]
    shapes += [(b, m, w) for b in (16, 17, 129, 512) for m in (63, 65, 4100)
               for w in (8, 9, 16, 24, 400)]
    for b, m, w in shapes:
        occ = torch.randint(-2**31, 2**31, (b, w), dtype=torch.int32,
                            device="cuda", generator=g)
        db = torch.randint(-2**31, 2**31, (m, w), dtype=torch.int32,
                           device="cuda", generator=g)
        got = kernel.support_count_cuda(occ, db)
        torch.cuda.synchronize()
        assert torch.equal(got, support_count_ref(occ, db)), (b, m, w)


@pytest.mark.cuda
def test_cuda_kernel_matches_ref_at_every_tile():
    """Every candidate tile (autotune.candidate_blocks) == the plain
    version (needs a card), at shapes that cross its row, item and K edges
    under both K plans (W = 65: chunks of 32 or 64 words), and each launch
    is counted under its tile."""
    from repro_torch.kernels.support_count import autotune

    _need_card()
    g = torch.Generator(device="cuda").manual_seed(1)
    for b, m, w in [(1, 33, 12), (17, 4100, 22), (111, 1191, 32), (129, 257, 65)]:
        occ = torch.randint(-2**31, 2**31, (b, w), dtype=torch.int32,
                            device="cuda", generator=g)
        db = torch.randint(-2**31, 2**31, (m, w), dtype=torch.int32,
                           device="cuda", generator=g)
        want = support_count_ref(occ, db)
        for tile in autotune.candidate_blocks(b, m, w):
            kernel.reset_counts()
            got = kernel.support_count_cuda(occ, db, blocks=tile)
            torch.cuda.synchronize()
            assert torch.equal(got, want), ((b, m, w), tile)
            assert kernel.launch_tiles == {(b, m, w, tile): 1}


@pytest.mark.cuda
def test_cuda_root_deal_matches_the_plain_deal():
    """The root deal on the card (the root's supports one B = 1 launch of
    the kernel at the problem's first deal, the dealt rows gathered there)
    builds the stacks the deal on the CPU builds, bit for bit, at P = 8
    over 20,000 items with two in every transaction; a second deal
    launches nothing."""
    from repro_torch.core import engine

    _need_card()
    rng = np.random.default_rng(5)
    db = rng.random((364, 20_000)) < 0.9
    db[:, [7, 12_345]] = True
    stacks = []
    for dev in ("cpu", "cuda"):
        before = kernel.launches
        packed = engine.pack_problem(db, None, device=dev)
        assert kernel.launches == before
        deal = engine.deal_roots(packed, 8, 4096, 340)
        engine.deal_roots(packed, 8, 4096, 345)
        assert kernel.launches == before + (dev == "cuda")
        carry = engine._Carry(deal=deal, db_tiles=packed.db_dev, lam0=340,
                              **engine.carry_dims(packed.n_pad, packed.npos_pad, "count"),
                              out_cap=4, trace_cap=0, device=packed.device)
        stacks.append((deal.n_roots, carry.to_fields(("occ_stack", "meta", "sp"))))
    (n_cpu, cpu), (n_cuda, cuda) = stacks
    assert n_cpu == n_cuda > 0
    for key in cpu:
        np.testing.assert_array_equal(cuda[key], cpu[key], err_msg=key)


@pytest.mark.cuda
def test_cuda_plain_session_launches_no_kernel():
    """A session on the card with kernel_impl "ref" counts everything with
    the plain version, the root's supports included: no kernel launch, and
    the same answer as the kernel's session on the same Dataset."""
    import repro_torch.api as tapi

    _need_card()
    rng = np.random.default_rng(6)
    db = rng.random((60, 300)) < 0.5
    db[:, [3, 200]] = True
    ds = tapi.Dataset.from_dense(db, None, name="plain", device="cuda")
    query = tapi.ClosedFrequentQuery(min_sup=35)
    reps = {}
    for impl in ("ref", "cuda"):
        s = tapi.MinerSession(4, device="cuda",
                              runtime=tapi.RuntimeConfig(kernel_impl=impl))
        before = kernel.launches
        reps[impl] = s.run(ds, query)
        assert (kernel.launches > before) == (impl == "cuda"), impl
        assert reps[impl].kernel_impl == impl
    assert reps["ref"].n_significant == reps["cuda"].n_significant > 0
    assert reps["ref"].results.to_json() == reps["cuda"].results.to_json()


@pytest.mark.cuda
def test_cuda_kernel_refuses_misaligned_db():
    """A view that does not start on a 16-byte boundary (db[1:] with W odd)
    is refused by the wrapper, before any launch."""
    _need_card()
    occ = torch.ones((4, 5), dtype=torch.int32, device="cuda")
    db = torch.ones((9, 5), dtype=torch.int32, device="cuda")
    view = db[1:]
    assert view.is_contiguous() and view.data_ptr() % 16
    before = kernel.launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        kernel.support_count_cuda(occ, view)
    assert kernel.launches == before


def test_load_builds_once_and_counts_lose_nothing_across_threads(monkeypatch):
    """Eight threads that load the kernel's library at the same moment build
    it once and share one handle; eight threads bumping the launch counters
    lose no count.  (`build` and `ctypes.CDLL` are stand-ins here: there is
    no nvcc.)"""
    import ctypes
    import sys
    import threading
    import time
    import types

    built = []

    def slow_build():
        built.append(threading.get_ident())
        time.sleep(0.05)           # every other thread arrives meanwhile
        return "libsupport_count_stub.so"

    monkeypatch.setattr(kernel, "build", slow_build)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: types.SimpleNamespace(
        path=path, sc_support_count=types.SimpleNamespace(),
        sc_error_string=types.SimpleNamespace()))
    monkeypatch.setattr(kernel, "_lib", None)
    start = threading.Barrier(8)
    handles = []

    def load():
        start.wait(timeout=10)
        handles.append(kernel._load())

    threads = [threading.Thread(target=load) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(built) == 1 and len(handles) == 8
    assert all(h is handles[0] for h in handles)

    n, shape, tile = 5000, (16, 2048, 32), (16, 64, 32)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)    # switch threads as often as possible
    try:
        kernel.reset_counts()
        bumpers = [threading.Thread(target=lambda: [
            kernel._count_launch(shape, tile) for _ in range(n)]) for _ in range(8)]
        for t in bumpers:
            t.start()
        for t in bumpers:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in bumpers)
    assert kernel.launches == 8 * n
    assert kernel.launch_shapes == {shape: 8 * n}
    assert kernel.launch_tiles == {(*shape, tile): 8 * n}
    kernel.reset_counts()
    assert kernel.launches == 0 and not kernel.launch_shapes
    assert not kernel.launch_tiles
