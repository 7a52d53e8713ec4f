"""Multi-process runtime initialization (port of the JAX package's
``parallel/distributed.py``).

Every process runs the same program; :func:`maybe_initialize_distributed`
joins them in one ``torch.distributed`` process group, and a mesh built
over :func:`global_devices` spans every process's devices
(``parallel/mesh.py``), as a JAX mesh over ``jax.devices()`` does under
``jax.distributed``.

Env contract (the JAX package's):

- ``PIO_NUM_HOSTS``            total processes (absent/1 = single process)
- ``PIO_HOST_INDEX``           this process's index [0, n)
- ``PIO_COORDINATOR_ADDRESS``  host:port of process 0

The CLI calls :func:`maybe_initialize_distributed` once at startup for
its compute commands; it is a no-op unless PIO_NUM_HOSTS > 1.

The backend follows the topology and is fixed before any collective
runs: NCCL only when every rank has cards of its own (it refuses two
ranks on one card), gloo otherwise — on the CPU, or where ranks share a
card, whose tensors the mesh then stages through host memory. The ranks
agree on it through the rendezvous store at the coordinator's address
(the store that ``init_method="tcp://..."`` would open), each posting
its host name and the cards it sees. Nothing here initializes CUDA: the
cards are counted by NVML, and no ``device_id`` is bound, so a process
that forks workers onto the card (``pio eval --parallel``) may still
fork. The module loads torch only when the group is made, so the
compute commands' single-process path imports nothing new.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import socket
from typing import Sequence

logger = logging.getLogger(__name__)

_initialized = False
#: the backend chosen at initialization ("gloo" or "nccl"); None before
BACKEND: str | None = None


def _topology() -> dict:
    """This process's host and the cards it sees (NVML; no CUDA context)."""
    import torch

    return {"host": socket.gethostname(), "cards": torch.cuda.device_count(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}


def choose_backend(ranks: Sequence[dict]) -> str:
    """"nccl" when every rank sees a card and the ranks of one host see
    disjoint card sets (each restricted by ``CUDA_VISIBLE_DEVICES``);
    else "gloo"."""
    if any(r["cards"] == 0 for r in ranks):
        return "gloo"
    hosts: dict[str, list] = {}
    for r in ranks:
        hosts.setdefault(r["host"], []).append(r)
    for same in hosts.values():
        if len(same) == 1:
            continue
        if any(not r["visible"] for r in same):
            return "gloo"   # unrestricted ranks of one host share its cards
        sets = [set(r["visible"].split(",")) for r in same]
        if any(a & b for a, b in itertools.combinations(sets, 2)):
            return "gloo"
    return "nccl"


def maybe_initialize_distributed() -> bool:
    """Initialize ``torch.distributed`` from the PIO_* env vars when
    configured. Returns whether multi-process mode is active. Idempotent."""
    global _initialized, BACKEND
    num_hosts = int(os.environ.get("PIO_NUM_HOSTS", "1"))
    if num_hosts <= 1:
        return False
    if _initialized:
        return True

    coordinator = os.environ.get("PIO_COORDINATOR_ADDRESS")
    host_index = os.environ.get("PIO_HOST_INDEX")
    if coordinator is None or host_index is None:
        raise RuntimeError(
            "PIO_NUM_HOSTS > 1 requires PIO_COORDINATOR_ADDRESS (host:port "
            "of host 0) and PIO_HOST_INDEX (this host's index)"
        )
    import torch.distributed as dist

    rank = int(host_index)
    host, port = coordinator.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_hosts, is_master=rank == 0)
    store.set(f"pio/topology/{rank}", json.dumps(_topology()))
    ranks = [json.loads(store.get(f"pio/topology/{r}")) for r in range(num_hosts)]
    BACKEND = choose_backend(ranks)
    dist.init_process_group(BACKEND, store=store, world_size=num_hosts, rank=rank)
    _initialized = True
    logger.info(
        "torch.distributed initialized: host %s of %s (coordinator %s), backend %s "
        "(cards seen by each rank: %s)", host_index, num_hosts, coordinator, BACKEND,
        [r["cards"] for r in ranks])
    return True


def global_devices(local: Sequence) -> tuple[list, list[int]]:
    """Every rank's ``local`` devices in rank order (``torch.device``s),
    and each one's owner (JAX's ``jax.devices()`` under
    ``jax.distributed``). A collective: every rank calls it."""
    import torch
    import torch.distributed as dist

    mine = [str(torch.device(d)) for d in local]
    gathered: list = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, mine)
    devices, owners = [], []
    for rank, devs in enumerate(gathered):
        devices += [torch.device(d) for d in devs]
        owners += [rank] * len(devs)
    return devices, owners


def is_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()
