"""The support-count kernel's tile (`repro_torch.kernels.support_count.
autotune`) and its way through the session: the default tile is the one
the kernel's C launcher chose before the tile became a parameter, the
seed table's rows win, candidates fit the shared memory, and the resolved
tile separates programs.  All on the CPU: choices are made for a named
card and SM count, and the kernel itself is the `cuda` tests'."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.api as tapi  # noqa: E402
from repro_torch.data.synthetic import SyntheticSpec, generate  # noqa: E402
from repro_torch.kernels.support_count import autotune  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"

#: every (B, M, W) of PERF.md's kernel table
PERF_SHAPES = [
    (128, 2048, 32), (64, 2048, 32), (16, 2048, 32), (512, 2048, 32),
    (256, 2048, 32), (364, 2048, 32), (111, 2048, 32), (473, 2048, 32),
    (10, 2048, 32), (128, 16384, 32), (204, 16384, 32), (128, 262144, 16),
    (64, 262144, 16), (295, 262144, 16), (128, 12288, 22), (128, 253952, 12),
    (128, 1191, 22), (512, 1191, 22), (512, 11914, 22), (1024, 11914, 22),
    (1024, 11916, 22),
] + [(b, 2048, 32) for b in (18, 43, 74, 217, 247, 250, 267, 268, 322, 341,
                              367, 404, 420, 437)]


def launcher_loop(B, M, W, sms=132):
    """The kernel's C launcher before the tile became a parameter, line for
    line (support_count.cu: kTileItems 64, kMaxWarps 8, kFlatMaxW 64,
    kChunkW 32): (rows, items, words staged per unit)."""
    kTileItems, kMaxWarps, kFlatMaxW, kChunkW = 64, 8, 64, 32
    ntiles = (M + kTileItems - 1) // kTileItems
    warps = min(kMaxWarps, (B + 15) // 16)
    row_blocks = (B + 16 * warps - 1) // (16 * warps)
    while warps > 1 and row_blocks * ntiles < 2 * sms:
        warps = (warps + 1) // 2
        row_blocks = (B + 16 * warps - 1) // (16 * warps)
    return 16 * warps, kTileItems, kFlatMaxW if kChunkW < W <= kFlatMaxW else kChunkW


@pytest.fixture(autouse=True)
def _no_seed_table():
    autotune.clear_seed_table()
    yield
    autotune.clear_seed_table()


@pytest.mark.parametrize("shape", PERF_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_default_tile_is_the_launchers(shape):
    """With no seed table the choice at every PERF.md shape is the tile the
    C launcher computed there (the issue's examples among them)."""
    got = autotune.choose_blocks(*shape, card=H100, sms=132)
    assert got == launcher_loop(*shape)
    assert got in autotune.candidate_blocks(*shape)


def test_default_tile_examples():
    c = dict(card=H100, sms=132)
    assert autotune.choose_blocks(128, 2048, 32, **c) == (16, 64, 32)
    assert autotune.choose_blocks(512, 2048, 32, **c) == (32, 64, 32)
    assert autotune.choose_blocks(128, 253952, 12, **c) == (128, 64, 32)
    assert autotune.choose_blocks(1024, 11914, 22, **c) == (128, 64, 32)
    assert autotune.choose_blocks(128, 2048, 32, "ref", **c) is None


def test_launcher_rule_over_a_sweep():
    """Wherever the loop lands on a power-of-two warp count the rule gives
    its tile; elsewhere (B up to 112 with 3, 5, 6 or 7 warps left) the
    next power of two, with the same number of row blocks."""
    rng = np.random.default_rng(0)
    for b, m, w, sms in zip(rng.integers(1, 1500, 400), rng.integers(1, 300_000, 400),
                            rng.integers(1, 130, 400), rng.choice([66, 114, 132], 400)):
        want = launcher_loop(int(b), int(m), int(w), int(sms))
        got = autotune.launcher_blocks(int(b), int(m), int(w), int(sms))
        assert got[1:] == want[1:]
        if want[0] in autotune.TILE_ROWS:
            assert got == want, (b, m, w, sms)
        else:
            assert got[0] == 1 << (want[0] - 1).bit_length()
            assert -(-b // got[0]) == -(-b // want[0])


def test_choice_is_deterministic_and_keyed_on_the_card(tmp_path):
    shape = (128, 2048, 32)
    picks = {autotune.choose_blocks(*shape, card=H100, sms=132) for _ in range(5)}
    assert picks == {(16, 64, 32)}
    rows = [{"impl": "cuda", "device": H100, "shape": list(shape),
             "blocks": [32, 32, 32], "time_us": 3.9, "modeled_us": 0.65},
            {"impl": "cuda", "device": H100, "shape": list(shape),
             "blocks": [64, 32, 32], "time_us": 4.1, "modeled_us": 0.98}]
    path = autotune.save_seed_table(str(tmp_path / "seed.json"), rows)
    assert autotune.load_seed_table(path) == 2
    assert autotune.choose_blocks(*shape, card=H100, sms=132) == (32, 32, 32)
    # another card, another shape or the plain version: the rule
    assert autotune.choose_blocks(*shape, card="NVIDIA H200", sms=132) == (16, 64, 32)
    assert autotune.choose_blocks(129, 2048, 32, card=H100, sms=132) == (16, 64, 32)
    assert autotune.choose_blocks(*shape, "ref", card=H100, sms=132) is None
    # the SM count moves the rule: 4 row blocks x 32 tiles fill 60 SMs
    assert autotune.choose_blocks(*shape, card="smaller", sms=60) == (32, 64, 32)


def test_seed_table_load_bumps_the_generation_and_clear_forgets(tmp_path):
    shape = (512, 2048, 32)
    gen0 = autotune._seed_gen
    assert autotune.choose_blocks(*shape, card=H100, sms=132) == (32, 64, 32)
    path = autotune.save_seed_table(str(tmp_path / "s.json"), [
        {"impl": "cuda", "device": H100, "shape": list(shape),
         "blocks": [128, 32, 32], "time_us": 5.0, "modeled_us": 1.6}])
    with open(path) as f:
        assert json.load(f)["suite"] == "support-count-autotune"
    autotune.load_seed_table(path)
    assert autotune._seed_gen == gen0 + 1          # the cached pick is stale
    assert autotune.choose_blocks(*shape, card=H100, sms=132) == (128, 32, 32)
    autotune.clear_seed_table()
    assert autotune._seed_gen == gen0 + 2
    assert autotune.choose_blocks(*shape, card=H100, sms=132) == (32, 64, 32)


def test_seed_row_that_is_no_candidate_is_skipped(tmp_path):
    path = autotune.save_seed_table(str(tmp_path / "s.json"), [
        {"impl": "cuda", "device": H100, "shape": [16, 2048, 32],
         "blocks": [128, 64, 32], "time_us": 1.0, "modeled_us": 1.0}])
    autotune.load_seed_table(path)
    assert autotune.choose_blocks(16, 2048, 32, card=H100, sms=132) == (16, 64, 32)


@pytest.mark.parametrize("content", ["not json", '{"rows": [{"impl": "cuda"}]}',
                                     '{"rows": 3}'])
def test_bad_env_seed_file_is_ignored(tmp_path, monkeypatch, content):
    """REPRO_TORCH_SC_AUTOTUNE is read at the first choice; a bad file
    never breaks the choice, as the JAX package's never breaks dispatch."""
    bad = tmp_path / "bad.json"
    bad.write_text(content)
    monkeypatch.setenv("REPRO_TORCH_SC_AUTOTUNE", str(bad))
    monkeypatch.setattr(autotune, "_env_loaded", False)
    assert autotune.choose_blocks(128, 2048, 32, card=H100, sms=132) == (16, 64, 32)
    assert autotune._env_loaded


def test_env_seed_file_is_loaded(tmp_path, monkeypatch):
    path = autotune.save_seed_table(str(tmp_path / "s.json"), [
        {"impl": "cuda", "device": H100, "shape": [128, 2048, 32],
         "blocks": [32, 32, 32], "time_us": 3.9, "modeled_us": 0.65}])
    monkeypatch.setenv("REPRO_TORCH_SC_AUTOTUNE", path)
    monkeypatch.setattr(autotune, "_env_loaded", False)
    assert autotune.choose_blocks(128, 2048, 32, card=H100, sms=132) == (32, 32, 32)


@pytest.mark.parametrize("w", [1, 12, 22, 32, 33, 64, 65, 96, 400, 2000])
def test_candidates_fit_the_shared_memory(w):
    """Every candidate fits 227 KiB a block; the instantiated tiles left out
    are exactly those that would not, and block_w = 64 only above 32
    words (below it both block_w run the same resident plan)."""
    b, m = 1024, 262144
    cands = autotune.candidate_blocks(b, m, w)
    assert cands
    full = [(r, i, bw) for r in autotune.TILE_ROWS for i in autotune.TILE_ITEMS
            for bw in autotune.TILE_WORDS if bw <= max(32, -(-w // 32) * 32)]
    for tile in full:
        fits = autotune.smem_bytes(tile, w) <= autotune.SMEM_BUDGET
        assert (tile in cands) == fits, tile
    assert all(t[2] == 32 for t in cands) == (w <= 32)
    if w == 96:   # the chunked plan at 64 words with 128 rows x 128 items
        assert (128, 128, 64) not in cands and (128, 64, 64) in cands


def test_candidates_follow_the_shape():
    assert autotune.candidate_blocks(1, 1, 1) == ((16, 32, 32),)
    assert {t[0] for t in autotune.candidate_blocks(17, 2048, 32)} == {16, 32}
    assert {t[1] for t in autotune.candidate_blocks(512, 97, 32)} == {32, 64, 128}
    assert {t[1] for t in autotune.candidate_blocks(512, 64, 32)} == {32, 64}


def test_smem_is_the_kernels_plan():
    """Spot values of the C `Plan` (words x 4 bytes): the resident plan at
    W = 32 with 16 rows x 64 items, the chunked one at W = 400 with
    128 rows x 32 items x 64 words."""
    # occ 16 x 36 + 3 stages of round_up(64*32 + 8, 4) + out 16 x 72
    assert autotune.smem_bytes((16, 64, 32), 32) == 4 * (16 * 36 + 3 * 2056 + 16 * 72)
    # 3 stages of (128 x 68 occ + 32 x 68 db) + out 128 x 40
    assert autotune.smem_bytes((128, 32, 64), 400) == 4 * (3 * (128 * 68 + 32 * 68) + 128 * 40)


def test_model_prices_bytes_and_parallelism():
    """The model's bound at a tile with one row block and every SM busy is
    the bytes term (the chip_smoke bound); fewer blocks than slots cost
    in proportion."""
    b, m, w = 128, 262144, 16
    t = autotune.modeled_time_us(b, m, w, (128, 64, 32))
    assert t == pytest.approx((m * w + b * w + b * m) * 4 / 3.35e12 * 1e6)
    few = autotune.modeled_time_us(16, 64, 32, (16, 32, 32))
    assert few > autotune.modeled_time_us(16, 64, 32, (16, 32, 32), sms=1)


def test_invalid_tile_names_the_candidates():
    with pytest.raises(ValueError, match=r"kernel_blocks \(8, 512, 32\).*"
                       r"\(16, 32, 32\), \(16, 64, 32\)"):
        autotune.check_blocks((8, 512, 32), 128, 2048, 32)
    with pytest.raises(ValueError, match="kernel_blocks"):
        autotune.check_blocks("tile", 128, 2048, 32)
    assert autotune.check_blocks([32, 128, 32], 128, 2048, 32) == (32, 128, 32)


# ------------------------------------------------------------------ resolve
def bucket():
    return tapi.ShapeBucket(1024, 128, 2048)   # W = 32, phase 4's bucket


def test_resolve_pins_the_tile_for_cuda(monkeypatch):
    """impl cuda: the tile of the superstep's launch, (P_local x
    expand_batch, bucket items, bucket words), on the session's card;
    impl ref: None."""
    monkeypatch.setattr(autotune, "card_info", lambda device=None: (H100, 132))
    monkeypatch.setattr(tapi.config, "resolve_impl", lambda impl, device: "cuda")
    cfg = tapi.RuntimeConfig().resolve(bucket(), 8, "cuda")
    assert cfg.kernel_impl == "cuda" and cfg.kernel_blocks == (16, 64, 32)
    # B = 16 x 32 = 512 miners' rows in one process, 16 x 4 in each of 8
    assert tapi.RuntimeConfig().resolve(bucket(), 32, "cuda").kernel_blocks == (32, 64, 32)
    assert tapi.RuntimeConfig().resolve(bucket(), 32, "cuda", n_local=4).kernel_blocks \
        == (16, 64, 32)
    pinned = tapi.RuntimeConfig(kernel_blocks=(32, 128, 32)).resolve(bucket(), 8, "cuda")
    assert pinned.kernel_blocks == (32, 128, 32)


def test_resolve_keeps_none_for_ref():
    cfg = tapi.RuntimeConfig().resolve(bucket(), 8, "cpu")
    assert cfg.kernel_impl == "ref" and cfg.kernel_blocks is None


def test_resolve_refuses_an_invalid_tile():
    with pytest.raises(ValueError, match=r"kernel_blocks \(8, 512, 32\).*valid"):
        tapi.RuntimeConfig(kernel_blocks=(8, 512, 32)).resolve(bucket(), 8, "cpu")
    # 256 rows per block are not an instantiation
    with pytest.raises(ValueError, match=r"\(128, 128, 32\)"):
        tapi.RuntimeConfig(kernel_blocks=(256, 64, 32)).resolve(bucket(), 8, "cpu")


def test_distinct_tiles_get_distinct_programs():
    """The resolved tile is part of the session's program cache key: a
    second tile builds its own programs, the same tile hits them."""
    db, labels, _ = generate(SyntheticSpec("t", 60, 48, 0.15, 16, 2, seed=0))
    ds = tapi.Dataset.from_dense(db, labels, device="cpu")
    q = tapi.SignificantPatternQuery(pipeline="fused23")
    session = tapi.MinerSession(device="cpu", runtime=tapi.RuntimeConfig(
        kernel_blocks=(16, 32, 32)))
    rep = session.run(ds, q)
    built = session.cache_info().misses
    assert built == len(rep.phases)
    session.runtime = tapi.RuntimeConfig(kernel_blocks=(16, 64, 32))
    rep2 = session.run(ds, q)
    assert session.cache_info().misses == 2 * built
    assert [p.kernel_blocks for p in rep2.phases] == [(16, 64, 32)] * len(rep2.phases)
    assert rep2.results.to_json() == rep.results.to_json()
    session.run(ds, q)
    assert session.cache_info().misses == 2 * built
