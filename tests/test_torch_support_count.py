"""The port's support-count dispatch (repro_torch.kernels.support_count) held
against the JAX package's (repro.kernels.support_count.ops).

Popcount sums are exact integers, so every comparison is bit-exact.  On the
CPU the port runs its plain PyTorch version; the CUDA kernel case runs only
where a card is present (chip_smoke.py holds the kernel against the plain
version at the engine's shapes on the card).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.support_count.ops import support_counts as jax_support_counts  # noqa: E402
from repro_torch.core.bitmap import (  # noqa: E402
    BitmapLayout,
    popcount32,
    supports_np,
    words_to_tensor,
)
from repro_torch.kernels.support_count import kernel, ops  # noqa: E402
from repro_torch.kernels.support_count.ref import support_count_ref  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    torch's default of one thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def test_cuda_kernel_matches_ref():
    """The CUDA kernel == the plain version, bit for bit (needs a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    for b, m, w in [(1, 1, 1), (7, 4095, 23), (33, 4097, 400), (128, 1191, 22)]:
        occ = torch.randint(-2**31, 2**31, (b, w), dtype=torch.int32,
                            device="cuda", generator=g)
        db = torch.randint(-2**31, 2**31, (m, w), dtype=torch.int32,
                           device="cuda", generator=g)
        got = kernel.support_count_cuda(occ, db)
        torch.cuda.synchronize()
        assert torch.equal(got, support_count_ref(occ, db)), (b, m, w)
