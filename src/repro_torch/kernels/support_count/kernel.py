"""The CUDA popcount-GEMM kernel: build, load, launch, count.

`csrc/support_count.cu` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface, at first use, into `build/repro_torch/`
at the root of the checkout (override with REPRO_TORCH_BUILD_DIR).  The
library's name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.  It is bound with
ctypes: pointers and the stream go as `c_void_p`, the kernel launches on
`torch.cuda.current_stream()`, and the C function returns
`cudaGetLastError()`, which the wrapper turns into an exception.

There is no fallback: a failed build or a failed launch raises.  The plain
version (`ref.support_count_ref`) is chosen by the dispatch in `ops.py`
only for tensors on the CPU.

`launches` counts the kernel launches made through `support_count_cuda`,
`launch_shapes` counts them by (B, M, W) and `launch_tiles` by (B, M, W,
tile); a run resets them (`reset_counts`) and reads them to show that its
path went through the kernel, at which shapes and with which tiles.  A
launch captured into a CUDA graph is counted at each replay of the graph
(`recording_launches`, `count_replayed`), not at the capture.

The tile is a (block_b, block_m, block_w) triple (`autotune.py`): the
caller's, or, given None, `autotune.choose_blocks` at the exact shape on
this card.

Sessions may launch from several threads at once (a serving fleet runs one
worker thread per session), so the library is built and loaded under one
lock, once per process, and the counters are bumped under another.  The
launch itself holds a third: the C function raises the dynamic
shared-memory limit of the tile's instantiation, a setting of the whole
process, where the launch needs more, just before it launches, and never
lowers it (a CUDA graph replays a captured launch against the limit in
force then).  The lock covers every instantiation and is held only while
the launch is enqueued.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from collections import Counter
from contextlib import contextmanager
from pathlib import Path

import torch

from . import autotune

__all__ = ["SOURCE", "NVCC_FLAGS", "build", "build_log", "count_replayed",
           "launch_shapes", "launch_tiles", "launches", "recording_launches",
           "reset_counts", "support_count_cuda"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "support_count.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_ALIGN = 16            # bytes: the kernel's cp.async copies and vector stores

#: kernel launches made through `support_count_cuda` since the last reset
launches = 0
#: the same launches by (B, M, W) shape
launch_shapes: Counter = Counter()
#: the same launches by (B, M, W, (block_b, block_m, block_w))
launch_tiles: Counter = Counter()

_lib = None
_build_log = ""
#: held while the library is built and loaded: one nvcc per process
_load_lock = threading.Lock()
#: held while the counters are read, bumped or reset
_count_lock = threading.Lock()
#: held from the kernel's shared-memory setting to its launch (C side)
_launch_lock = threading.Lock()
#: a thread's launches recorded in a CUDA graph capture (`recording_launches`)
_recording = threading.local()


def _build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/support_count/kernel.py -> checkout root
    return Path(__file__).resolve().parents[4] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "support_count CUDA kernel cannot be built"
    )


def build() -> Path:
    """Compile the kernel if its library is not built yet; return its path."""
    global _build_log
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = _build_dir()
    lib_path = out_dir / f"support_count_{key}.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    _build_log = (
        f"nvcc {time.perf_counter() - t0:.2f}s: {' '.join(cmd)}\n"
        f"{proc.stdout}{proc.stderr}"
    )
    return lib_path


def build_log() -> str:
    """nvcc's command, time and `-Xptxas -v` report from this process's build."""
    return _build_log


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is None:   # another thread may have loaded it while we waited
            lib = ctypes.CDLL(str(build()))
            lib.sc_support_count.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.sc_support_count.restype = ctypes.c_int
            lib.sc_error_string.argtypes = [ctypes.c_int]
            lib.sc_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _count_launch(shape: tuple[int, int, int], tile: tuple[int, int, int]) -> None:
    global launches
    recorded = getattr(_recording, "launches", None)
    if recorded is not None:   # a CUDA graph capture: nothing launched yet
        recorded[(shape, tile)] += 1
        return
    with _count_lock:
        launches += 1
        launch_shapes[shape] += 1
        launch_tiles[(*shape, tile)] += 1


@contextmanager
def recording_launches():
    """Within it, this thread's calls of `support_count_cuda` are recorded
    into the Counter it yields, by ((B, M, W), tile), and not counted: a
    CUDA graph capture calls the wrapper but launches nothing.  Each
    replay of the graph then counts them with `count_replayed`."""
    recorded = Counter()
    _recording.launches = recorded
    try:
        yield recorded
    finally:
        _recording.launches = None


def count_replayed(recorded: Counter) -> None:
    """Count the launches `recording_launches` recorded, once more: a
    replay of the graph they were captured into launched them."""
    global launches
    with _count_lock:
        for (shape, tile), n in recorded.items():
            launches += n
            launch_shapes[shape] += n
            launch_tiles[(*shape, tile)] += n


def reset_counts() -> None:
    """Set `launches` to 0 and clear `launch_shapes` and `launch_tiles`."""
    global launches
    with _count_lock:
        launches = 0
        launch_shapes.clear()
        launch_tiles.clear()


def support_count_cuda(occ: torch.Tensor, db: torch.Tensor,
                       blocks: tuple[int, int, int] | None = None) -> torch.Tensor:
    """occ [B, W] int32, db [M, W] int32 (item-major), both contiguous on
    one CUDA device, each starting on a 16-byte boundary -> S [B, M] int32,
    one kernel launch with the tile `blocks` (None: `autotune.
    choose_blocks` at this shape; a tile that is not a candidate of the
    shape raises)."""
    for name, t in (("occ", occ), ("db", db)):
        if t.device.type != "cuda":
            raise ValueError(f"support_count_cuda: {name} is on {t.device}, not CUDA")
        if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(
                f"support_count_cuda: {name} must be a contiguous 2-D int32 "
                f"tensor, got {t.dtype} {tuple(t.shape)}"
            )
        if t.data_ptr() % _ALIGN:
            raise ValueError(
                f"support_count_cuda: {name} does not start on a {_ALIGN}-byte "
                f"boundary (a view at an offset?); pass a fresh or whole tensor"
            )
    if occ.device != db.device:
        raise ValueError(f"occ on {occ.device} but db on {db.device}")
    b, w = occ.shape
    m, w2 = db.shape
    if w != w2:
        raise ValueError(f"word widths differ: occ {tuple(occ.shape)}, db {tuple(db.shape)}")
    out = torch.empty((b, m), dtype=torch.int32, device=occ.device)
    if b == 0 or m == 0:
        return out
    if blocks is None:
        card, sms = autotune.card_info(occ.device)
        tile = autotune.choose_blocks(b, m, w, "cuda", card=card, sms=sms)
    else:
        tile = autotune.check_blocks(blocks, b, m, w)
    lib = _load()
    with torch.cuda.device(occ.device):
        stream = torch.cuda.current_stream(occ.device).cuda_stream
        with _launch_lock:
            rc = lib.sc_support_count(
                occ.data_ptr(), db.data_ptr(), out.data_ptr(), b, m, w, *tile, stream
            )
    if rc != 0:
        raise RuntimeError(
            f"support_count kernel launch failed at {(b, m, w)} with tile "
            f"{tile}: {lib.sc_error_string(rc).decode()}"
        )
    _count_launch((b, m, w), tile)
    return out
