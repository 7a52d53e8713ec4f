"""EngineContext: the handle threaded through the DASE hooks (port of the
JAX package's ``workflow/context.py``).

It carries the storage registry, the workflow params, one torch device
(the card unless the caller asks for the CPU) and, built on first use,
the device mesh over the context's devices (``parallel/mesh.py``): the
axes of ``WorkflowParams.mesh_conf["axes"]`` (``{"data": 4, "seq": 2}``
trains sessionrec over a sequence mesh, with ring attention over "seq"),
or ``("data", "model")`` factored from the device count. The devices are
the ones the caller passes (a list may repeat a device: ``["cuda:0"] * 4``
lays a 4-position mesh over one card), else every card, else the CPU.
Under an initialized process group (``parallel/distributed.py``) they are
every rank's devices in rank order, each owned by its rank, and the mesh
spans the processes. Training takes its seed from the algorithm's params.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.data.store import EventStore
from predictionio_tpu_torch.parallel import distributed
from predictionio_tpu_torch.parallel.mesh import Mesh
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.device import available_devices, resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class WorkflowParams:
    """The JAX package's workflow flags that training and evaluation read
    (``batch`` is the run's label, which engine and evaluation instances
    record; ``mesh_conf`` is engine.json's ``meshConf``, the axis spec)."""

    batch: str = ""
    save_model: bool = True
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False
    mesh_conf: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    #: set by ``run_train`` before the pipeline runs, so persistence hooks
    #: key their checkpoints by training run
    engine_instance_id: str = ""
    #: the algorithm-list slot being persisted, set by ``Engine.train``
    algorithm_slot: int = 0


def _factor_mesh(n: int) -> tuple[int, int]:
    """The default (data, model) factorization of n devices: the model
    axis is the largest divisor of n at most sqrt(n)."""
    best = 1
    for m in range(1, int(math.isqrt(n)) + 1):
        if n % m == 0:
            best = m
    return (n // best, best)


class EngineContext:
    """One per workflow run. ``devices`` (a list of devices, repeats
    allowed) are the mesh's; without it, every card when ``device`` is the
    card, else the CPU. Counting the cards initializes no CUDA context.
    Under a process group those are this rank's devices, and ``devices``
    lists every rank's (gathered on first use: a collective)."""

    def __init__(
        self,
        workflow_params: WorkflowParams = WorkflowParams(),
        storage: Storage | None = None,
        device: str | torch.device | None = None,
        mesh: Mesh | None = None,
        devices: Sequence[str | torch.device] | None = None,
    ):
        self.workflow_params = workflow_params
        self._storage = storage
        self._devices = [torch.device(d) for d in devices] if devices else None
        self.device = resolve_device(
            device if device is not None or not self._devices else self._devices[0])
        self._mesh = mesh
        self._global: tuple[list[torch.device], list[int]] | None = None

    def with_workflow_params(self, **changes) -> "EngineContext":
        """A context on the same storage, device and devices with some
        workflow params replaced (a new ``mesh_conf`` builds a new mesh)."""
        mesh = None if "mesh_conf" in changes else self._mesh
        ctx = EngineContext(dataclasses.replace(self.workflow_params, **changes),
                            self._storage, self.device, mesh, self._devices)
        ctx._global = self._global
        return ctx

    def with_axes(self, **axes: int) -> "EngineContext":
        """A context whose mesh uses an explicit axis spec."""
        return self.with_workflow_params(
            mesh_conf={**self.workflow_params.mesh_conf, "axes": axes})

    @property
    def devices(self) -> list[torch.device]:
        local = list(self._devices) if self._devices else available_devices(self.device)
        if not distributed.is_initialized():
            return local
        if self._global is None:
            self._global = distributed.global_devices(local)
        return list(self._global[0])

    @property
    def device_ranks(self) -> list[int]:
        """The owning rank of each of ``devices`` (all 0 in one process)."""
        devices = self.devices
        return list(self._global[1]) if self._global is not None else [0] * len(devices)

    @property
    def mesh(self) -> Mesh:
        """The device mesh, built on first use from mesh_conf
        (``{"axes": {"data": 4, "model": 2}}``) or factored from the
        device count."""
        if self._mesh is None:
            devices = self.devices
            axes_conf = self.workflow_params.mesh_conf.get("axes")
            if axes_conf:
                names = tuple(axes_conf.keys())
                sizes = tuple(int(v) for v in axes_conf.values())
            else:
                names = ("data", "model")
                sizes = _factor_mesh(len(devices))
            total = math.prod(sizes)
            if total > len(devices):
                raise ValueError(
                    f"mesh axes {dict(zip(names, sizes))} need {total} devices, "
                    f"have {len(devices)}")
            grid = np.empty(total, dtype=object)
            grid[:] = devices[:total]
            ranks = (np.asarray(self.device_ranks[:total]).reshape(sizes)
                     if distributed.is_initialized() else None)
            self._mesh = Mesh(grid.reshape(sizes), names, ranks=ranks)
            logger.info("created mesh %s over %d %s device(s)", dict(zip(names, sizes)),
                        total, devices[0].type)
        return self._mesh

    @property
    def mesh_if_parallel(self) -> Mesh | None:
        """The mesh when it spans more than one position, else None: one
        device takes the plain path (the same math, no collectives)."""
        if len(self.devices) <= 1:
            return None
        mesh = self.mesh
        return mesh if mesh.size > 1 else None

    @property
    def num_devices(self) -> int:
        return self.mesh.size

    @property
    def storage(self) -> Storage:
        if self._storage is None:
            self._storage = Storage()
        return self._storage

    def event_store(self) -> EventStore:
        return EventStore(self.storage)
