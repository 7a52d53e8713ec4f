"""Crash-safe model checkpoints, the ``npz`` backend of the JAX package's
``utils/checkpoint.py`` (a copy: the port imports nothing of that
package). The two packages read each other's npz checkpoints.

- The payload is written to a temp path, fsync'd and atomically renamed
  to a name derived from its content (``arrays-<digest>.npz``);
- ``checkpoint_meta.json`` is replaced atomically LAST and names the
  payload, so a crash mid-save leaves the previous meta pointing at the
  previous (still present) payload;
- the meta's manifest names every array with its shape, dtype and
  SHA-256; :func:`load_sharded` verifies it and raises
  :class:`CheckpointCorruptError` on any mismatch.

A checkpoint the JAX package wrote with orbax needs JAX to read:
:func:`load_sharded` raises for it.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Mapping

import numpy as np

_META_FILE = "checkpoint_meta.json"
_NPZ_FILE = "arrays.npz"
_ORBAX_SUBDIR = "orbax"
_META_VERSION = 2


class CheckpointCorruptError(RuntimeError):
    """The checkpoint fails integrity verification (torn write, bit flip,
    missing file): it must not be served."""


def _array_meta(value: np.ndarray) -> dict:
    host = np.ascontiguousarray(value)
    return {"shape": list(host.shape), "dtype": str(host.dtype),
            "sha256": hashlib.sha256(host.tobytes()).hexdigest()}


def save_sharded(directory: str, arrays: Mapping[str, np.ndarray]) -> str:
    """Persist a flat {name: np.ndarray} mapping; returns the backend,
    always "npz" (the module docstring has the crash-safety rules)."""
    os.makedirs(directory, exist_ok=True)
    arrays = {name: np.asarray(v) for name, v in arrays.items()}
    manifest = {name: _array_meta(v) for name, v in arrays.items()}
    digest = hashlib.sha256(json.dumps(manifest, sort_keys=True).encode()).hexdigest()[:16]
    payload_name = f"arrays-{digest}.npz"
    final = os.path.join(directory, payload_name)
    tmp = f"{final}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _write_meta(directory, "npz", manifest, payload=payload_name)
    # the commit landed: earlier generations' payloads are garbage now
    for stale in os.listdir(directory):
        if (stale.startswith("arrays-") and stale.endswith(".npz")
                and stale != payload_name) or stale == _NPZ_FILE:
            try:
                os.unlink(os.path.join(directory, stale))
            except OSError:
                pass
    return "npz"


def load_sharded(directory: str) -> dict[str, np.ndarray]:
    """Host arrays saved by :func:`save_sharded` (either package's npz
    backend), verified against the manifest when there is one."""
    meta = _read_meta(directory)
    if meta.get("backend", "npz") == "orbax":
        raise RuntimeError(
            f"checkpoint at {directory} was written by orbax, and reading orbax needs "
            "JAX; save it with the npz backend to load it here")
    payload_name = meta.get("payload", _NPZ_FILE)
    try:
        with np.load(os.path.join(directory, payload_name)) as data:
            out = {k: data[k] for k in data.files}
    except FileNotFoundError:
        raise CheckpointCorruptError(
            f"checkpoint at {directory} is missing {payload_name} — "
            "incomplete or deleted save") from None
    except Exception as exc:  # truncated or garbled zip payload
        raise CheckpointCorruptError(
            f"checkpoint at {directory} is unreadable ({exc}) — "
            "torn write or corruption") from exc
    _verify(directory, out, meta.get("arrays"))
    return out


def _verify(directory: str, arrays: Mapping[str, np.ndarray],
            manifest: Mapping[str, Any] | None) -> None:
    """Arrays against the manifest; a checkpoint without one (version 1)
    loads unverified."""
    if manifest is None:
        return
    have, want = set(arrays), set(manifest)
    if have != want:
        raise CheckpointCorruptError(
            f"checkpoint at {directory} does not match its manifest: "
            f"missing {sorted(want - have)}, unexpected {sorted(have - want)}")
    for name, meta in manifest.items():
        value = arrays[name]
        if list(value.shape) != list(meta.get("shape", ())):
            raise CheckpointCorruptError(
                f"checkpoint array {name!r} at {directory} has shape "
                f"{list(value.shape)}, manifest says {meta.get('shape')}")
        if str(value.dtype) != meta.get("dtype", ""):
            raise CheckpointCorruptError(
                f"checkpoint array {name!r} at {directory} has dtype "
                f"{value.dtype}, manifest says {meta.get('dtype')}")
        expected = meta.get("sha256")
        if expected and hashlib.sha256(
                np.ascontiguousarray(value).tobytes()).hexdigest() != expected:
            raise CheckpointCorruptError(
                f"checkpoint array {name!r} at {directory} fails its content "
                "checksum — bit flip or torn write; refusing to load a corrupted model")


def _write_meta(directory: str, backend: str, arrays: Mapping[str, Any] | None = None,
                payload: str | None = None) -> None:
    # fsync then os.replace: readers see the old complete meta or the new one
    path = os.path.join(directory, _META_FILE)
    tmp = f"{path}.tmp.{os.getpid()}"
    doc: dict[str, Any] = {"backend": backend, "version": _META_VERSION}
    if arrays is not None:
        doc["arrays"] = dict(arrays)
    if payload is not None:
        doc["payload"] = payload
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_meta(directory: str) -> dict:
    meta_path = os.path.join(directory, _META_FILE)
    if not os.path.exists(meta_path):
        # no meta: a complete orbax checkpoint wins over a legacy npz
        if os.path.isdir(os.path.join(directory, _ORBAX_SUBDIR)):
            return {"backend": "orbax"}
        return {"backend": "npz"}
    try:
        with open(meta_path) as f:
            doc = json.load(f)
    except (json.JSONDecodeError, OSError) as exc:
        raise CheckpointCorruptError(
            f"checkpoint meta at {meta_path} is unreadable ({exc})") from exc
    if not isinstance(doc, dict):
        raise CheckpointCorruptError(f"checkpoint meta at {meta_path} is not a JSON object")
    return doc
