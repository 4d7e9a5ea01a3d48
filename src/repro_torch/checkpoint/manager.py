"""Fault-tolerant checkpoint manager: counterpart of
``repro/checkpoint/manager.py``, with its on-disk format, so a directory
written by either package restores in the other.

* atomic step directories: each save writes ``step_N.tmp.*``, fsyncs the
  manifest, renames it to ``step_N`` and fsyncs the parent directory, so
  a crash mid-write never corrupts the newest valid checkpoint and the
  commit itself survives a power cut;
* ``manifest.json`` holds ``step``, ``extra`` and ``arrays``: per array
  its file (the first 16 hex digits of ``md5(key)`` plus ``.npy``), the
  SHA-256 of the file's bytes, its shape and dtype. ``restore`` and
  ``restore_arrays`` verify every digest and raise
  :class:`CheckpointError` rather than return bytes they cannot vouch
  for;
* keep-N garbage collection, which also sweeps ``step_N.tmp.*`` orphans
  left by a hard kill mid-``save``;
* ``latest_step()`` is the newest *valid* step.

Trees are nested dicts (and lists or tuples) of tensors or arrays; keys
join with ``/`` in the order JAX's ``tree_map_with_path`` visits them
(``repro_torch.tree``: dict keys sorted, sequences by index; ``None`` is
no leaf). A tensor on the card is copied to the host before it is saved;
a DTensor leaf is saved as its ``full_tensor()``, so a directory written
from a device mesh holds the arrays one written without a mesh holds.
``restore(..., shardings=)`` places each leaf that has a sharding on its
mesh (``launch/sharding.NamedSharding``), as the reference's
``jax.device_put(arr, sh)`` does: the elastic-rescale path.
The session layer (``repro_torch.sessions``) drives this manager for
trajectory state.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import items as _items
from repro_torch.tree import unflatten as _unflatten

__all__ = ["CheckpointError", "CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)$")
_TMP_RE = re.compile(r"^step_\d+\.tmp\.")


class CheckpointError(RuntimeError):
    """A checkpoint could not be restored: missing step or array,
    manifest absent or unreadable, or an on-disk digest that no longer
    matches the manifest (torn write, bitflip). Callers fall back to an
    earlier step through ``latest_step()``."""


def _host(x) -> np.ndarray:
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _fsync_dir(path: str) -> None:
    """Flush a directory entry to disk (a rename is durable only once the
    parent directory is fsynced)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, extra: Optional[dict] = None) -> str:
        tmp = tempfile.mkdtemp(prefix=f"step_{step}.tmp.", dir=self.dir)
        manifest = {"step": step, "extra": extra or {}, "arrays": {}}
        try:
            for key, val in _items(tree):
                arr = _host(val)
                fname = hashlib.md5(key.encode()).hexdigest()[:16] + ".npy"
                fpath = os.path.join(tmp, fname)
                np.save(fpath, arr)
                with open(fpath, "rb") as f:
                    digest = hashlib.sha256(f.read()).hexdigest()
                manifest["arrays"][key] = {
                    "file": fname, "sha256": digest,
                    "shape": list(arr.shape), "dtype": str(arr.dtype),
                }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            final = os.path.join(self.dir, f"step_{step}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)           # atomic on POSIX
            _fsync_dir(self.dir)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
        # orphaned step_N.tmp.* dirs of a process killed mid-save (a live
        # save renames its own tmp before it calls _gc)
        for name in os.listdir(self.dir):
            if _TMP_RE.match(name):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in
                      (_STEP_RE.match(n) for n in os.listdir(self.dir)) if m)

    def _manifest(self, step: int) -> dict:
        d = os.path.join(self.dir, f"step_{step}")
        mpath = os.path.join(d, "manifest.json")
        if not os.path.exists(mpath):
            raise CheckpointError(
                f"step {step}: no checkpoint at {d} (or manifest missing)")
        try:
            with open(mpath) as f:
                return json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointError(
                f"step {step}: unreadable manifest: {e}") from e

    def _verified_path(self, step: int, key: str, meta: dict) -> str:
        """Path of an array file whose SHA-256 matches the manifest;
        :class:`CheckpointError` otherwise."""
        fpath = os.path.join(self.dir, f"step_{step}", meta["file"])
        try:
            with open(fpath, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
        except OSError as e:
            raise CheckpointError(
                f"step {step}: array {key!r} unreadable: {e}") from e
        if digest != meta["sha256"]:
            raise CheckpointError(
                f"step {step}: array {key!r} fails its SHA-256 "
                f"(torn write or bitflip) — refusing to restore")
        return fpath

    def is_valid(self, step: int) -> bool:
        try:
            for key, meta in self._manifest(step)["arrays"].items():
                self._verified_path(step, key, meta)
            return True
        except Exception:      # any unreadable manifest or file
            return False

    def latest_step(self) -> Optional[int]:
        for s in reversed(self.all_steps()):
            if self.is_valid(s):
                return s
        return None

    def restore_arrays(self, step: int) -> Dict[str, np.ndarray]:
        """Every array of the manifest as numpy, keyed by its flattened
        path, digest-verified: the resume path of callers that rebuild
        their own containers (``repro_torch.sessions``)."""
        manifest = self._manifest(step)
        return {key: np.load(self._verified_path(step, key, meta))
                for key, meta in manifest["arrays"].items()}

    def restore(self, step: int, like, device: DeviceLike = None,
                shardings=None):
        """Restore into the structure of ``like`` as tensors on ``device``
        (None = the CUDA device, or raise). If ``shardings`` (a tree of
        ``like``'s structure whose leaves are ``NamedSharding``s or None)
        is given, each leaf with a sharding becomes a DTensor placed on its
        mesh (``distribute_tensor``). Every array is verified first: a
        digest mismatch, a truncated file, or a key ``like`` has and the
        manifest lacks raises :class:`CheckpointError`."""
        dev = resolve_device(device)
        manifest = self._manifest(step)
        flat_sh = dict(_items(shardings)) if shardings is not None else {}
        values = {}
        for key, _ in _items(like):
            meta = manifest["arrays"].get(key)
            if meta is None:
                raise CheckpointError(
                    f"step {step}: array {key!r} missing from the "
                    f"manifest — checkpoint does not match the requested "
                    f"structure")
            arr = np.load(self._verified_path(step, key, meta))
            values[key] = torch.from_numpy(np.array(arr)).to(dev)
            sh = flat_sh.get(key)
            if sh is not None:
                values[key] = distribute_tensor(values[key], sh.mesh,
                                                sh.placements)
        return _unflatten(like, values)

    def extra(self, step: int) -> dict:
        return self._manifest(step)["extra"]
