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

Memory-mapped loading (``pio deploy --workers N --model-mmap``):
``load_sharded(..., mmap_mode="r")`` maps each npz member's raw ``.npy``
bytes out of the page cache instead of copying them onto the heap, so
the N workers of a pool that load one checkpoint share one physical
HOST copy of the factor tables. ``PIO_CHECKPOINT_MMAP=r`` turns it on
for every load (read per call). The card does not share: each worker
still copies the tables into its own CUDA context
(:func:`host_tensor`). A mapped load verifies the manifest's shapes and
dtypes but skips the content hash, which would read every byte: the
save path's fsync and atomic rename already keep a torn payload from
being named. Any mapping failure (a compressed member, a legacy layout)
logs a warning and falls back to the eager, verified load.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import warnings
from typing import Any, Mapping

import numpy as np
import torch

logger = logging.getLogger(__name__)

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


def default_mmap_mode() -> str | None:
    """``"r"`` when ``PIO_CHECKPOINT_MMAP`` is ``r``/``1``/``true``/
    ``yes``/``on``, else None (the eager, verified load). Read at call
    time, never at import."""
    raw = os.environ.get("PIO_CHECKPOINT_MMAP", "").strip().lower()
    if raw in ("r", "1", "true", "yes", "on"):
        return "r"
    return None


def _mmap_npz(path: str) -> dict[str, np.ndarray]:
    """Every member of an uncompressed npz as a read-only ``np.memmap``
    view into the archive file. Raises on anything unexpected (a
    compressed member, an object array, a short file): the caller falls
    back to the eager load."""
    import zipfile

    from numpy.lib import format as npy_format

    out: dict[str, np.ndarray] = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"member {info.filename!r} is compressed; "
                                 "mmap needs raw stored bytes")
            name = info.filename
            if name.endswith(".npy"):
                name = name[:-4]
            # the zip local file header is variable length: read its
            # name and extra lengths to land on the .npy data
            f.seek(info.header_offset)
            local = f.read(30)
            if len(local) != 30 or local[:4] != b"PK\x03\x04":
                raise ValueError("torn local header")
            name_len = int.from_bytes(local[26:28], "little")
            extra_len = int.from_bytes(local[28:30], "little")
            f.seek(info.header_offset + 30 + name_len + extra_len)
            # the public header readers (the JAX package calls numpy's
            # private _read_array_header, which newer numpy no longer
            # exports from numpy.lib.format)
            version = npy_format.read_magic(f)
            reader = {(1, 0): npy_format.read_array_header_1_0,
                      (2, 0): npy_format.read_array_header_2_0}.get(version)
            if reader is None:
                raise ValueError(f"member {name!r} has .npy format {version}")
            shape, fortran, dtype = reader(f)
            if dtype.hasobject:
                raise ValueError(f"member {name!r} holds objects; not mappable")
            out[name] = np.memmap(path, dtype=dtype, mode="r", shape=shape,
                                  offset=f.tell(), order="F" if fortran else "C")
    return out


def load_sharded(directory: str, mmap_mode: str | None = None) -> dict[str, np.ndarray]:
    """Host arrays saved by :func:`save_sharded` (either package's npz
    backend), verified against the manifest when there is one.

    ``mmap_mode="r"`` maps the arrays instead of copying them (read-only
    ``np.memmap`` views; shapes and dtypes verified, content hashes
    skipped: module docstring). None defers to
    :func:`default_mmap_mode`."""
    meta = _read_meta(directory)
    if meta.get("backend", "npz") == "orbax":
        raise RuntimeError(
            f"checkpoint at {directory} was written by orbax, and reading orbax needs "
            "JAX; save it with the npz backend to load it here")
    payload_name = meta.get("payload", _NPZ_FILE)
    path = os.path.join(directory, payload_name)
    if mmap_mode is None:
        mmap_mode = default_mmap_mode()
    if mmap_mode is not None:
        try:
            out = _mmap_npz(path)
        except FileNotFoundError:
            raise CheckpointCorruptError(
                f"checkpoint at {directory} is missing {payload_name} — "
                "incomplete or deleted save") from None
        except Exception as exc:  # degrade to the eager verified load
            logger.warning("mmap load of %s failed (%s); falling back to the eager "
                           "copy-and-verify load", path, exc)
        else:
            _verify(directory, out, meta.get("arrays"), check_sums=False)
            return out
    try:
        with np.load(path) as data:
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


def host_tensor(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A loaded checkpoint array as a tensor on ``device``. A mapped
    (read-only) array is aliased, not copied: on the card the transfer
    reads the shared pages once into this process's own device copy;
    on the CPU the tensor IS the mapping, so nothing may ever write into
    it in place (a write to a read-only mapping kills the process).
    ``torch.from_numpy`` warns about non-writable arrays; the aliasing is
    the point here, so that warning is silenced."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(array).to(device)


def _verify(directory: str, arrays: Mapping[str, np.ndarray],
            manifest: Mapping[str, Any] | None, check_sums: bool = True) -> None:
    """Arrays against the manifest (content hashes when ``check_sums``);
    a checkpoint without one (version 1) loads unverified."""
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
        if check_sums and expected and hashlib.sha256(
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
