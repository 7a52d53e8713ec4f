"""Model persistence: the per-algorithm models of a training run as one
blob in the MODELDATA repository (port of the JAX package's
``workflow/persistence.py``).

Each algorithm's entry is what its ``make_persistent_model`` returned:

1. a model: pickled, with every tensor first moved to a host NumPy
   array (the counterpart of the JAX package's ``_to_host``) that
   remembers its dtype; :func:`load_models` puts each back as a tensor
   on the deploy's device, so the model serves as it trained;
2. a ``PersistentModelManifest``: the algorithm saved the model itself
   (the port's templates write npz checkpoints) and the blob records
   where;
3. ``None``: nothing persisted; the model is retrained at deploy.

Every blob carries the magic ``PIOM\\x01`` and a SHA-256 digest of its
payload. :func:`deserialize_models` checks the digest before it
unpickles anything: a flipped bit, a torn write or a missing header
raises :class:`ModelIntegrityError` and the deploy never serves it.

A blob is not meant to be read by the other package: a pickle names
its package's classes (the manifest, the templates' models). What the
two packages share is the storage itself (the sqlite file, the engine
instance rows) and the npz checkpoints a manifest points at.
"""

from __future__ import annotations

import dataclasses
import hashlib
import pickle
from typing import Any, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.controller.base import PersistentModelManifest
from predictionio_tpu_torch.storage.base import Model
from predictionio_tpu_torch.storage.registry import Storage

_FORMAT_VERSION = 1

#: blob header: magic + format byte, then a 32-byte SHA-256 of the
#: pickled payload, then the payload
_MAGIC = b"PIOM\x01"
_DIGEST_LEN = hashlib.sha256().digest_size


class ModelIntegrityError(ValueError):
    """The persisted model blob fails its checksum (bit flip, torn or
    truncated write): the deploy fails and never unpickles or serves it."""


@dataclasses.dataclass(frozen=True)
class _Envelope:
    version: int
    entries: tuple[tuple[str, Any], ...]  # (mode, payload); mode: auto|manifest|none


@dataclasses.dataclass(frozen=True)
class _HostTensor:
    """A tensor on the host: its values as a NumPy array (bf16 widened
    to f32, which NumPy lacks, exactly) and its torch dtype's name."""

    array: np.ndarray
    dtype: str


def _map_leaves(x: Any, fn, leaf: type) -> Any:
    """``fn`` applied to every ``leaf`` instance, through dataclasses
    and containers (NamedTuples keep their type)."""
    if isinstance(x, leaf):
        return fn(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(
            x, **{f.name: _map_leaves(getattr(x, f.name), fn, leaf)
                  for f in dataclasses.fields(x) if f.init})
    if isinstance(x, dict):
        return {k: _map_leaves(v, fn, leaf) for k, v in x.items()}
    if isinstance(x, tuple):
        out = [_map_leaves(v, fn, leaf) for v in x]
        return type(x)(*out) if hasattr(x, "_fields") else tuple(out)
    if isinstance(x, list):
        return [_map_leaves(v, fn, leaf) for v in x]
    return x


def _to_host(t: torch.Tensor) -> _HostTensor:
    t = t.detach().cpu()
    return _HostTensor((t.float() if t.dtype == torch.bfloat16 else t).numpy(),
                       str(t.dtype).removeprefix("torch."))


def serialize_models(persisted: Sequence[Any]) -> bytes:
    entries: list[tuple[str, Any]] = []
    for p in persisted:
        if p is None:
            entries.append(("none", None))
        elif isinstance(p, PersistentModelManifest):
            entries.append(("manifest", p))
        else:
            entries.append(("auto", _map_leaves(p, _to_host, torch.Tensor)))
    payload = pickle.dumps(_Envelope(_FORMAT_VERSION, tuple(entries)),
                           protocol=pickle.HIGHEST_PROTOCOL)
    return _MAGIC + hashlib.sha256(payload).digest() + payload


def deserialize_models(blob: bytes, device: str | torch.device) -> list[Any]:
    """The per-algorithm persisted list (model | manifest | None) for
    ``Engine.prepare_deploy``, after the digest check; a model's tensors
    come back on ``device`` in their own dtypes."""
    header_len = len(_MAGIC) + _DIGEST_LEN
    if not blob.startswith(_MAGIC):
        raise ModelIntegrityError("model blob lacks its PIOM header; refusing to "
                                  "deserialize bytes that carry no checksum")
    if len(blob) < header_len:
        raise ModelIntegrityError("model blob is truncated inside its integrity header")
    digest, payload = blob[len(_MAGIC):header_len], blob[header_len:]
    if hashlib.sha256(payload).digest() != digest:
        raise ModelIntegrityError(
            "model blob fails its SHA-256 checksum — bit flip or torn write; "
            "refusing to deserialize a corrupted model")
    env: _Envelope = pickle.loads(payload)
    if env.version != _FORMAT_VERSION:
        raise ValueError(f"unsupported model blob version {env.version}")

    def to_device(h: _HostTensor) -> torch.Tensor:
        return torch.from_numpy(h.array).to(device=device, dtype=getattr(torch, h.dtype))

    return [_map_leaves(p, to_device, _HostTensor) if mode == "auto" else p
            for mode, p in env.entries]


def save_models(storage: Storage, instance_id: str, persisted: Sequence[Any]) -> None:
    storage.get_model_data_models().insert(
        Model(id=instance_id, models=serialize_models(persisted)))


def load_models(storage: Storage, instance_id: str,
                device: str | torch.device) -> list[Any]:
    model = storage.get_model_data_models().get(instance_id)
    if model is None:
        raise KeyError(f"no persisted models for engine instance {instance_id}")
    return deserialize_models(model.models, device)
