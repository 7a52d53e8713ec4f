"""Where algorithms that persist their own models put them (the
location half of the JAX package's ``controller/persistent_model.py``).

The port's templates save npz checkpoints (``utils/checkpoint.py`` for
ALS, ``params.npz`` + ``model.json`` for sessionrec) at
:func:`checkpoint_location` and record a ``PersistentModelManifest``
that points there.
"""

from __future__ import annotations

import os
import uuid
from typing import Any


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
