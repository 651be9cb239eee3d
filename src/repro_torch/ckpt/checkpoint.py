"""Checkpoint/restore with corruption detection (counterpart of
`repro.ckpt.checkpoint`, with the same on-disk format).

Format: <dir>/step_<N>/
  manifest.json       tree structure, shapes/dtypes/crc32s, metadata, step
  arrays.npz          one entry per leaf (flattened key path)

Leaves are named as `jax.tree_util.tree_flatten_with_path` names them in
the JAX package — dict keys sorted, list/tuple positions by index, the
parts joined by "::" — so either package reads the other's steps.  A leaf
is a numpy array, a torch tensor or a scalar; `None` holds no leaf.

Crash safety (DESIGN.md §11): a step is staged into a dot-prefixed tmp dir
(invisible to `list_steps`) and *published* by a rename sequence that keeps
a complete copy on disk at every instant — rename the old step aside,
rename the tmp in, delete the aside.  `.old_step_N`/`.tmp_step_N`
leftovers are dot-prefixed and never mistaken for steps.

Corruption detection: the manifest records a crc32 per stored leaf;
`restore`/`load_step` verify on read and raise `CorruptCheckpoint`, and
`restore_latest` falls back to the newest step that still verifies (with a
RuntimeWarning naming the ones it skipped).

bfloat16 and float8 leaves, which npz cannot store, are stored as
same-width integer views (`_VIEW_AS`) and come back as torch tensors of
their dtype.  Arrays are stored whole; `restore(..., device=)` places them
on the device the resuming run uses, whatever the device count of the run
that wrote them.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import warnings
import zipfile
import zlib

import numpy as np
import torch

from repro_torch.testing import faults

__all__ = [
    "CheckpointError",
    "CorruptCheckpoint",
    "latest_step",
    "list_steps",
    "load_step",
    "restore",
    "restore_latest",
    "save",
]

_SEP = "::"
# dtypes numpy's npz cannot store natively: save as a same-width integer view
_VIEW_AS = {
    "bfloat16": np.uint16,
    "float8_e4m3fn": np.uint8,
    "float8_e5m2": np.uint8,
}
# the torch dtype of each, and the same-width integer dtype both torch and
# numpy hold (the bytes in between)
_TORCH_VIEW = {"bfloat16": (torch.bfloat16, torch.int16, np.int16),
               "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
               "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8)}


class CheckpointError(RuntimeError):
    """A checkpoint could not be written or read."""


class CorruptCheckpoint(CheckpointError):
    """A step dir exists but fails structural or checksum verification."""


def _leaves(tree, path=()):
    """(key path, leaf) pairs in `tree_flatten_with_path` order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, path + (str(i),))
    else:
        yield path, tree


def _flatten(tree) -> dict:
    return {_SEP.join(path): leaf for path, leaf in _leaves(tree)}


def _unflatten(tree, values: dict, path=()):
    """`tree` with each leaf replaced by values[its key]."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, values, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_unflatten(x, values, path + (str(i),)) for i, x in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    return values[_SEP.join(path)]


def _stored(leaf) -> tuple[np.ndarray, str]:
    """(the array npz stores, the manifest dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if name in _TORCH_VIEW:
            return t.view(_TORCH_VIEW[name][1]).numpy().view(_VIEW_AS[name]), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    name = str(arr.dtype)
    if name in _VIEW_AS:   # an ml_dtypes array handed in by a caller
        return arr.view(_VIEW_AS[name]), name
    return arr, name


def _crc32(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def save(tree, directory: str, step: int, *, meta: dict | None = None, keep: int = 3):
    """Crash-safe checkpoint write; prunes old steps.

    Publish ordering (a complete step dir exists on disk at every instant):
    stage into `.tmp_step_N`, rename any existing `step_N` aside to
    `.old_step_N`, rename the tmp in, delete the aside.  The manifest
    carries a crc32 per stored leaf for corruption detection on restore.
    """
    tmp = os.path.join(directory, f".tmp_step_{step}")
    final = os.path.join(directory, f"step_{step}")
    aside = os.path.join(directory, f".old_step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    stored, dtypes = {}, {}
    for k, v in _flatten(tree).items():
        stored[k], dtypes[k] = _stored(v)
    manifest = {
        "step": step,
        "meta": meta or {},
        "leaves": {
            k: {
                "shape": list(v.shape),
                "dtype": dtypes[k],
                # checksum of the *stored* bytes (post-_VIEW_AS view)
                "crc32": _crc32(v),
            }
            for k, v in stored.items()
        },
    }
    np.savez(os.path.join(tmp, "arrays.npz"), **stored)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    faults.check("ckpt.pre_publish", step=step, path=tmp)
    # publish: old aside -> tmp in -> aside gone.  A crash between any two
    # renames leaves a complete copy (`step_N` or `.old_step_N`) on disk.
    if os.path.exists(aside):
        shutil.rmtree(aside)
    if os.path.exists(final):
        os.rename(final, aside)
    os.rename(tmp, final)
    if os.path.exists(aside):
        shutil.rmtree(aside)
    faults.check("ckpt.published", step=step, path=final)
    # prune
    steps = sorted(list_steps(directory))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)
    return final


def list_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str):
    steps = list_steps(directory)
    return steps[-1] if steps else None


def load_step(directory: str, step: int, *, verify: bool = True):
    """Raw read of one step: (dict key -> array, manifest).

    Arrays come back as numpy arrays in their manifest dtypes, except the
    `_VIEW_AS` dtypes, which come back as CPU torch tensors of that dtype.
    Raises `CorruptCheckpoint` on structural damage (unreadable manifest or
    zip) or — with `verify` (default) — on any per-leaf crc32/shape
    mismatch.  This is the reader `restore`/`restore_latest` and the
    frontier restore (`repro_torch.ckpt.mining`) build on.
    """
    path = os.path.join(directory, f"step_{step}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(path, "arrays.npz"))
    except (OSError, json.JSONDecodeError, zipfile.BadZipFile, ValueError) as e:
        raise CorruptCheckpoint(
            f"step {step} in {directory} is unreadable: {e}") from e
    out = {}
    for key, want in manifest.get("leaves", {}).items():
        try:
            arr = data[key]
        except Exception as e:  # zip-level damage raises varied types
            raise CorruptCheckpoint(
                f"step {step}: leaf {key!r} unreadable: {e}") from e
        if verify:
            crc = want.get("crc32")
            if crc is not None and _crc32(arr) != crc:
                raise CorruptCheckpoint(
                    f"step {step}: leaf {key!r} failed its crc32 check "
                    "(bytes on disk do not match the manifest)")
        if verify and list(arr.shape) != want["shape"]:
            raise CorruptCheckpoint(
                f"step {step}: leaf {key!r} shape {list(arr.shape)} != "
                f"manifest {want['shape']}")
        if want["dtype"] in _TORCH_VIEW:
            dtype, _, np_view = _TORCH_VIEW[want["dtype"]]
            arr = torch.from_numpy(arr.view(np_view).copy()).view(dtype)
        out[key] = arr
    return out, manifest


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def _as_target(arr, target, device):
    """`arr` in the dtype and kind (tensor or numpy) of `target`; a numpy
    target becomes a tensor on `device` when one is given."""
    if isinstance(target, torch.Tensor):
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.array(arr))
        return t.to(device=target.device if device is None else device,
                    dtype=target.dtype)
    if isinstance(arr, torch.Tensor):
        raise TypeError("a bfloat16/float8 leaf restores into a torch.Tensor target")
    out = np.array(arr, dtype=np.asarray(target).dtype)
    return out if device is None else torch.from_numpy(out).to(device)


def restore(directory: str, step: int, target_tree, device=None):
    """Restore into the structure of target_tree (numpy arrays, tensors or
    scalars as leaves).

    A leaf comes back in its target's dtype: a tensor on `device` (default:
    the target tensor's device) when the target is a tensor or a device is
    given, else a numpy array.  Raises KeyError when the checkpoint lacks a
    target leaf, ValueError on a target shape mismatch, and
    `CorruptCheckpoint` on damaged data.
    """
    data, manifest = load_step(directory, step)
    values = {}
    for key, target in _flatten(target_tree).items():
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = data[key]
        if tuple(arr.shape) != _shape(target):
            raise ValueError(f"shape mismatch for {key}: {tuple(arr.shape)} vs "
                             f"{_shape(target)}")
        values[key] = _as_target(arr, target, device)
    return _unflatten(target_tree, values), manifest


def restore_latest(directory: str, target_tree, device=None):
    """Restore the newest step that verifies; corrupt steps are skipped
    (with a RuntimeWarning) and the next-newest is tried.  Returns
    (None, None) when no valid step exists."""
    for step in reversed(list_steps(directory)):
        try:
            return restore(directory, step, target_tree, device)
        except CorruptCheckpoint as e:
            warnings.warn(
                f"skipping corrupt checkpoint step {step} in {directory}: "
                f"{e}", RuntimeWarning, stacklevel=2)
    return None, None
