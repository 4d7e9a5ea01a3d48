"""Packed quantized-model artifacts: counterpart of ``repro/server/artifact.py``.

The serving representation is the artifact: one versioned ``.npz``
holding the ``QuantizedParams`` tree exactly as the engine consumes it —
nibble-packed uint8 ``w4`` data, int8 ``w8`` data, fp32 per-column
scales, fp32 passthrough leaves — plus the ``ServeConfig`` and
``So3kratesConfig`` it was quantized for. The layout, the manifest, the
version tag and the refusals are the JAX package's, so a file written by
either package loads in the other:

* **cold start** is ``load_engine(path)``: read and verify, then build —
  no fp32 tree, no quantization pass;
* **bit-exactness** is structural: the tensors the loaded engine serves
  with are byte for byte the saved ones (tensors are written through
  ``.cpu().numpy()`` and read back onto the engine's device only after
  every checksum has passed);
* **integrity**: atomic write (temp file, fsync, rename), a manifest with
  a SHA-256 per leaf, and :class:`ArtifactError` — never silent garbage
  — for truncated files, checksum mismatches and format-version skew.

Layout inside the ``.npz``::

    __manifest__          JSON (utf-8 bytes as a uint8 array): magic,
                          version, mode, model_cfg, serve_cfg, fp32_bytes,
                          serving_bytes, per-leaf {kind, has_scale,
                          sha256(data)}
    q/<name>/data         QTensor payload (int8 / packed uint8 / fp32)
    q/<name>/scale        per-output-channel fp32 scales (quantized kinds)
    a/<name>              non-QTensor fp32 leaves (embeddings, norms, ...)

The version bumps whenever the layout or the meaning of a field changes;
``load_artifact`` refuses other versions rather than guessing.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import zipfile
from typing import Dict, Optional

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.so3krates import So3kratesConfig
from repro_torch.serving.engine import QuantizedEngine, ServeConfig
from repro_torch.serving.qparams import QTensor, serving_bytes
from repro_torch.weights import qparams_from_numpy

__all__ = ["ArtifactError", "ARTIFACT_MAGIC", "ARTIFACT_VERSION",
           "save_artifact", "load_artifact", "load_engine", "LoadedArtifact",
           "ensure_mode_matches"]

ARTIFACT_MAGIC = "repro-quantized-so3-artifact"
ARTIFACT_VERSION = 1


class ArtifactError(RuntimeError):
    """A packed artifact could not be read: truncated/corrupt file,
    checksum mismatch, or a format version this code does not speak."""


def ensure_mode_matches(artifact_mode: str, serve_mode: str) -> None:
    """The mode-compatibility rule for packed weights: an artifact's
    payloads *are* its quantization mode, so a serving config may
    override any other knob but never ``mode``."""
    if serve_mode != artifact_mode:
        raise ArtifactError(
            f"ServeConfig.mode {serve_mode!r} != artifact mode "
            f"{artifact_mode!r}: packed weights cannot change mode — "
            "re-export from the fp32 checkpoint instead")


def _sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


@dataclasses.dataclass(frozen=True)
class LoadedArtifact:
    """A verified artifact, its leaves as numpy (serving-format tree:
    :class:`QTensor` leaves holding numpy data and scales, arrays
    elsewhere), ready for :func:`load_engine` to place on a device."""
    qparams: Dict[str, object]
    model_cfg: So3kratesConfig
    serve: ServeConfig
    fp32_bytes: int          # footprint of the fp32 tree this came from
    file_bytes: int          # size of the artifact on disk
    # short content tag over the per-leaf SHA-256s: two artifacts carry
    # the same tag iff their weight payloads are byte-identical
    version_tag: str = ""

    @property
    def compression_x(self) -> float:
        return self.fp32_bytes / max(self.file_bytes, 1)


def _version_tag(leaves: Dict[str, dict]) -> str:
    """Deterministic content tag: SHA-256 over the sorted per-leaf
    digests (weights only), truncated to 12 hex digits."""
    h = hashlib.sha256()
    for name in sorted(leaves):
        h.update(name.encode("utf-8"))
        h.update(leaves[name]["sha256"].encode("ascii"))
    return h.hexdigest()[:12]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_artifact(path: str, engine: QuantizedEngine) -> int:
    """Serialize an engine's serving-format parameters and configs to one
    versioned ``.npz`` at ``path``, atomically (temp file, fsync,
    rename: a crash mid-write never leaves a half-artifact there).
    Returns the artifact's byte size."""
    arrays: Dict[str, np.ndarray] = {}
    leaves = {}
    for name, v in engine.qparams.items():
        if isinstance(v, QTensor):
            data = _host(v.data)
            arrays[f"q/{name}/data"] = data
            leaf = {"kind": v.kind, "has_scale": v.scale is not None,
                    "sha256": _sha256(data)}
            if v.scale is not None:
                arrays[f"q/{name}/scale"] = _host(v.scale)
        else:
            data = _host(v)
            arrays[f"a/{name}"] = data
            leaf = {"kind": "array", "has_scale": False,
                    "sha256": _sha256(data)}
        leaves[name] = leaf
    manifest = {
        "magic": ARTIFACT_MAGIC,
        "version": ARTIFACT_VERSION,
        "mode": engine.serve.mode,
        "model_cfg": dataclasses.asdict(engine.model_cfg),
        "serve_cfg": dataclasses.asdict(engine.serve),
        "fp32_bytes": engine.memory_report()["fp32_bytes"],
        "serving_bytes": serving_bytes(engine.qparams),
        "leaves": leaves,
    }
    # utf-8 bytes, not a numpy unicode array (dtype <U pads to 4 B/char)
    arrays["__manifest__"] = np.frombuffer(
        json.dumps(manifest).encode("utf-8"), dtype=np.uint8)

    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(suffix=".npz.tmp", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)            # atomic on POSIX
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return os.path.getsize(path)


def _dataclass_from(cls, fields: dict):
    # tuples arrive back from JSON as lists; restore hashable field types
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in fields:
            continue                     # saved by an older minor config: skip
        v = fields[f.name]
        kw[f.name] = tuple(v) if isinstance(v, list) else v
    return cls(**kw)


def load_artifact(path: str) -> LoadedArtifact:
    """Read a packed artifact back as numpy, verifying magic, version and
    every leaf's SHA-256. Raises :class:`ArtifactError` (with the reason)
    on a truncated/corrupt file, a version this code does not speak, or
    any checksum mismatch — never returns partially-loaded parameters."""
    try:
        file_bytes = os.path.getsize(path)
        with np.load(path, allow_pickle=False) as z:
            if "__manifest__" not in z.files:
                raise ArtifactError(
                    f"{path}: no __manifest__ — not a packed artifact")
            manifest = json.loads(
                z["__manifest__"].tobytes().decode("utf-8"))
            arrays = {k: z[k] for k in z.files if k != "__manifest__"}
    except ArtifactError:
        raise
    except (OSError, zipfile.BadZipFile, ValueError, KeyError) as e:
        raise ArtifactError(f"{path}: unreadable artifact "
                            f"(truncated or corrupt): {e}") from e

    if manifest.get("magic") != ARTIFACT_MAGIC:
        raise ArtifactError(f"{path}: bad magic {manifest.get('magic')!r} "
                            f"(expected {ARTIFACT_MAGIC!r})")
    version = manifest.get("version")
    if version != ARTIFACT_VERSION:
        raise ArtifactError(
            f"{path}: artifact version {version!r} != supported "
            f"{ARTIFACT_VERSION} — re-export the artifact with this "
            "code (the format is not forward/backward compatible)")

    qparams: Dict[str, object] = {}
    for name, leaf in manifest["leaves"].items():
        key = f"a/{name}" if leaf["kind"] == "array" else f"q/{name}/data"
        if key not in arrays:
            raise ArtifactError(f"{path}: missing payload for leaf "
                                f"{name!r} ({key})")
        data = arrays[key]
        if _sha256(data) != leaf["sha256"]:
            raise ArtifactError(f"{path}: checksum mismatch on {name!r} "
                                "— artifact is corrupt")
        if leaf["kind"] == "array":
            qparams[name] = data
            continue
        scale = None
        if leaf["has_scale"]:
            skey = f"q/{name}/scale"
            if skey not in arrays:
                raise ArtifactError(
                    f"{path}: missing scale for leaf {name!r}")
            scale = arrays[skey]
        qparams[name] = QTensor(leaf["kind"], data, scale)

    model_cfg = _dataclass_from(So3kratesConfig, manifest["model_cfg"])
    serve = _dataclass_from(ServeConfig, manifest["serve_cfg"])
    return LoadedArtifact(qparams=qparams, model_cfg=model_cfg, serve=serve,
                          fp32_bytes=int(manifest["fp32_bytes"]),
                          file_bytes=file_bytes,
                          version_tag=_version_tag(manifest["leaves"]))


def load_engine(path: str, serve: Optional[ServeConfig] = None,
                device: DeviceLike = None) -> QuantizedEngine:
    """Cold-start an engine from a packed artifact: verify, place the
    leaves on ``device`` (None = the CUDA device, or raise) and build —
    no fp32 tree, no quantization pass. ``serve`` overrides the
    artifact's serving knobs (bucket ladder, path, max_batch), but its
    ``mode`` must match the artifact's."""
    device = resolve_device(device)
    art = load_artifact(path)
    if serve is None:
        serve = art.serve
    else:
        ensure_mode_matches(art.serve.mode, serve.mode)
    qparams = qparams_from_numpy(art.qparams, device)
    return QuantizedEngine.from_quantized(art.model_cfg, qparams, serve,
                                          fp32_nbytes=art.fp32_bytes,
                                          device=device,
                                          artifact_version=art.version_tag)
