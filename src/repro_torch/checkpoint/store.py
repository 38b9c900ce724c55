"""Checkpoints of parameter and optimizer trees: the PyTorch counterpart of
``repro/checkpoint/store.py``, in the same on-disk format.

A checkpoint is a directory holding ``arrays.npz`` (every leaf as a full
numpy array, keyed by its ``/``-joined path with ``/`` written as ``|``)
and ``manifest.json`` (step, meta, and each key's shape and dtype).  Paths
are built as the reference builds them (dict keys sorted, list and tuple
items by index), and bf16 leaves are widened to fp32 on save (npz cannot
hold bf16) and restored to the skeleton's dtype, so a checkpoint written by
either package restores in the other.

Durability contract, as in the reference:

* :func:`save` is atomic at the directory level: arrays and manifest are
  staged in a hidden temp directory beside ``path`` and renamed into place
  (two renames when a checkpoint is already there), so a fault at any point
  leaves the old complete checkpoint or none, never a half-written one.
* :func:`restore` validates before it deserializes: a missing or corrupted
  ``arrays.npz``, manifest/npz key drift, or a skeleton that does not match
  the stored keys raise :class:`CheckpointError`.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

from ..tree import paths, unflatten_like


class CheckpointError(RuntimeError):
    """A checkpoint is missing, incomplete, corrupted, or does not match
    the skeleton it is being restored into."""


def _flatten(tree) -> dict[str, Any]:
    """Each leaf under its ``/``-joined path, in flattening order."""
    return {"/".join(map(str, p)): leaf for p, leaf in paths(tree)}


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:   # npz cannot store bf16
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def save(path: str, tree, step: int = 0, meta: dict | None = None) -> None:
    """Write ``tree`` under ``path`` atomically: stage into a temp dir in
    the same parent, then rename into place (replacing any previous
    checkpoint at ``path`` only after the new one is complete)."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    manifest = {
        "step": step,
        "meta": meta or {},
        "keys": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                 for k, v in arrays.items()},
    }
    tmp = tempfile.mkdtemp(dir=parent, prefix=".ck-tmp-")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k.replace("/", "|"): v for k, v in arrays.items()})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.lexists(path):
            old = tempfile.mkdtemp(dir=parent, prefix=".ck-old-")
            # two renames: the previous checkpoint stays complete (just
            # relocated) until the new one is in place
            os.rename(path, os.path.join(old, "ck"))
            os.rename(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def peek(path: str) -> dict:
    """Load and return just the manifest (step, meta, keys); validates
    that ``path`` holds a complete, parseable checkpoint header."""
    mf = os.path.join(path, "manifest.json")
    if not os.path.isfile(mf):
        raise CheckpointError(
            f"no manifest.json under {path!r} — not a checkpoint "
            f"(or an interrupted save)")
    try:
        with open(mf) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointError(
            f"unreadable manifest.json under {path!r}: {e}") from e
    if not isinstance(manifest, dict) or "keys" not in manifest:
        raise CheckpointError(
            f"malformed manifest under {path!r}: missing 'keys'")
    return manifest


def _load_arrays(path: str, manifest: dict) -> dict[str, np.ndarray]:
    npz = os.path.join(path, "arrays.npz")
    if not os.path.isfile(npz):
        raise CheckpointError(
            f"no arrays.npz under {path!r} — incomplete checkpoint")
    try:
        with np.load(npz) as data:
            # force every member through the zip CRC so truncation or
            # corruption surfaces here, not as garbage values later
            flat = {k.replace("|", "/"): np.asarray(data[k])
                    for k in data.files}
    except Exception as e:  # BadZipFile, zlib error, pickle refusals, ...
        raise CheckpointError(
            f"corrupted arrays.npz under {path!r}: {e}") from e
    mkeys = set(manifest["keys"])
    if set(flat) != mkeys:
        missing = sorted(mkeys - set(flat))
        extra = sorted(set(flat) - mkeys)
        raise CheckpointError(
            f"manifest/arrays key drift under {path!r}: "
            f"missing from npz {missing}, not in manifest {extra}")
    for k, info in manifest["keys"].items():
        if list(flat[k].shape) != list(info["shape"]):
            raise CheckpointError(
                f"checkpoint {path!r} key {k!r}: stored shape "
                f"{list(flat[k].shape)} != manifest shape {info['shape']}")
    return flat


def restore(path: str, skeleton):
    """Restore into the structure of ``skeleton``, a tree of tensors ->
    (tree, step): each leaf comes back with its skeleton leaf's dtype (bf16
    narrowed from the stored fp32) on its device.

    Raises :class:`CheckpointError` (never a bare ``KeyError``) when the
    checkpoint is incomplete or corrupted or its keys do not match the
    skeleton's structure."""
    manifest = peek(path)
    flat = _load_arrays(path, manifest)
    skel = _flatten(skeleton)
    if set(skel) != set(flat):
        missing = sorted(set(skel) - set(flat))
        extra = sorted(set(flat) - set(skel))
        raise CheckpointError(
            f"checkpoint {path!r} does not match the restore skeleton: "
            f"skeleton keys absent from checkpoint {missing}, "
            f"checkpoint keys absent from skeleton {extra}")
    return unflatten_like(skeleton, [
        torch.from_numpy(flat[k]).to(device=t.device, dtype=t.dtype)
        for k, t in skel.items()]), manifest["step"]
