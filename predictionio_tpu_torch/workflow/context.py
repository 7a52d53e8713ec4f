"""EngineContext: the handle threaded through the DASE hooks (port of the
JAX package's ``workflow/context.py``).

Where the JAX context carries a device mesh and a PRNG key chain, this
one carries one torch device (the card unless the caller asks for the
CPU). Training takes its seed from the algorithm's params. Ring
attention over several cards is ROADMAP.md queue 1 item 15.
"""

from __future__ import annotations

import dataclasses

import torch

from predictionio_tpu_torch.data.store import EventStore
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class WorkflowParams:
    """The JAX package's workflow flags that training and evaluation read
    (``batch`` is the run's label, which engine and evaluation instances
    record)."""

    batch: str = ""
    save_model: bool = True
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False
    #: set by ``run_train`` before the pipeline runs, so persistence hooks
    #: key their checkpoints by training run
    engine_instance_id: str = ""
    #: the algorithm-list slot being persisted, set by ``Engine.train``
    algorithm_slot: int = 0


class EngineContext:
    """One per workflow run."""

    def __init__(
        self,
        workflow_params: WorkflowParams = WorkflowParams(),
        storage: Storage | None = None,
        device: str | torch.device | None = None,
    ):
        self.workflow_params = workflow_params
        self._storage = storage
        self.device = resolve_device(device)

    def with_workflow_params(self, **changes) -> "EngineContext":
        """A context on the same storage and device with some workflow
        params replaced."""
        return EngineContext(dataclasses.replace(self.workflow_params, **changes),
                             self._storage, self.device)

    @property
    def storage(self) -> Storage:
        if self._storage is None:
            self._storage = Storage()
        return self._storage

    def event_store(self) -> EventStore:
        return EventStore(self.storage)
