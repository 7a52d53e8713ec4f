"""Custom model persistence: where algorithms that persist their own
models put them, and the contract by which a model persists itself (port
of the JAX package's ``controller/persistent_model.py``).

The port's templates save npz checkpoints (``utils/checkpoint.py`` for
ALS, ``params.npz`` + ``model.json`` for sessionrec) at
:func:`checkpoint_location` and record a ``PersistentModelManifest``
that points there. A user's model that implements
:class:`PersistentModel` owns its persistence instead: ``save`` stores
the artifact, the train workflow records only a manifest, and at deploy
the class's ``load`` restores it. Algorithms get this through
:class:`PersistentModelAlgorithmMixin`.
"""

from __future__ import annotations

import abc
import logging
import os
import pickle
import uuid
from typing import Any

from predictionio_tpu_torch.controller.base import PersistentModelManifest
from predictionio_tpu_torch.utils.reflection import resolve_attr

logger = logging.getLogger(__name__)


def model_base_dir() -> str:
    """Where local model artifacts live: ``$PIO_MODEL_DIR``, else
    ``$PIO_FS_BASEDIR/models``, else ``~/.pio_store/models``."""
    if os.environ.get("PIO_MODEL_DIR"):
        return os.environ["PIO_MODEL_DIR"]
    base = os.environ.get("PIO_FS_BASEDIR",
                          os.path.join(os.path.expanduser("~"), ".pio_store"))
    return os.path.join(base, "models")


def checkpoint_location(ctx: Any, prefix: str) -> str:
    """``<model_base_dir>/<prefix>_<run>_a<slot>``: keyed by the training
    run (its engine instance id, else a fresh uuid) and the algorithm's
    slot, so successive runs and multi-algorithm engines never collide."""
    run_id = ctx.workflow_params.engine_instance_id or uuid.uuid4().hex
    return os.path.join(model_base_dir(),
                        f"{prefix}_{run_id}_a{ctx.workflow_params.algorithm_slot}")


class PersistentModel(abc.ABC):
    """A model that persists itself (the reference's PersistentModel
    trait). ``save`` returns True when it stored the model (the workflow
    then persists only a manifest); False falls back to the pickled
    model blob."""

    @abc.abstractmethod
    def save(self, instance_id: str, params: Any) -> bool: ...

    @classmethod
    @abc.abstractmethod
    def load(cls, instance_id: str, params: Any) -> "PersistentModel":
        """The model ``save`` stored under ``instance_id`` (the
        reference's PersistentModelLoader)."""


class LocalFileSystemPersistentModel(PersistentModel):
    """Pickles the model to ``<model_base_dir>/<instance_id>`` (the
    reference's LocalFileSystemPersistentModel and its loader)."""

    def save(self, instance_id: str, params: Any) -> bool:
        path = os.path.join(model_base_dir(), instance_id)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(self, f, protocol=pickle.HIGHEST_PROTOCOL)
        logger.info("saved persistent model to %s", path)
        return True

    @classmethod
    def load(cls, instance_id: str, params: Any) -> "LocalFileSystemPersistentModel":
        path = os.path.join(model_base_dir(), instance_id)
        with open(path, "rb") as f:
            return pickle.load(f)


class PersistentModelAlgorithmMixin:
    """Mixin for algorithms whose models implement :class:`PersistentModel`:
    ``make_persistent_model`` and ``load_model`` go through the model's
    own ``save`` and ``load``."""

    def make_persistent_model(self, ctx: Any, model: Any) -> Any:
        if isinstance(model, PersistentModel):
            run_id = ctx.workflow_params.engine_instance_id or uuid.uuid4().hex
            # slot suffix: multi-algorithm engines must not share locations
            location = f"{run_id}_a{ctx.workflow_params.algorithm_slot}"
            if model.save(location, getattr(self, "params", None)):
                return PersistentModelManifest(
                    class_name=f"{type(model).__module__}.{type(model).__qualname__}",
                    location=location)
        return model

    def load_model(self, ctx: Any, manifest: PersistentModelManifest) -> Any:
        model_cls = resolve_attr(manifest.class_name)
        return model_cls.load(manifest.location, getattr(self, "params", None))
