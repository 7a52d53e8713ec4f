"""Best-effort CPU-affinity placement for the prefork pool (a copy of the
JAX package's ``serving/placement.py``).

``pio deploy --workers N`` leaves the kernel free to move N engine
processes across cores; that costs cache locality (each worker's host
model pages, batcher state and shared-cache slots migrate between cache
domains) and, on multi-socket hosts, cross-NUMA traffic against the
mapped factor tables. Pinning each worker to a contiguous stripe of the
allowed CPU list keeps its working set on one domain: contiguous CPU ids
are the portable proxy for "same socket".

Everything here is best-effort: a host with fewer allowed CPUs than
workers, a platform without ``sched_setaffinity`` or a denied call
returns ``None`` and changes nothing. Placement never stops a worker
from starting.
"""

from __future__ import annotations

import logging
import os
from collections.abc import Iterable

logger = logging.getLogger(__name__)


def assign_worker_cpus(index: int, total: int,
                       cpus: Iterable[int]) -> frozenset[int] | None:
    """The contiguous CPU stripe worker ``index`` of ``total`` should
    pin to, carved from the ALLOWED cpu list (so an outer cgroup/taskset
    restriction is respected, never widened). None when placement can't
    help: a single worker (nothing to separate) or fewer CPUs than
    workers (pinning would serialize siblings a free scheduler could
    still interleave)."""
    cpu_list = sorted(set(cpus))
    if total <= 1 or index < 0 or index >= total:
        return None
    if len(cpu_list) < total:
        return None
    per, extra = divmod(len(cpu_list), total)
    start = index * per + min(index, extra)
    size = per + (1 if index < extra else 0)
    return frozenset(cpu_list[start:start + size])


def apply_worker_affinity(index: int, total: int,
                          cpus: Iterable[int] | None = None
                          ) -> frozenset[int] | None:
    """Pin THIS process to its stripe; returns the applied CPU set, or
    None when the platform/topology says don't (logged at debug — this
    is the expected outcome on 1-core CI hosts, not an error).

    ``cpus`` is the pool-wide allowed set to carve stripes from. The
    deploy CLI captures it ONCE, before the parent pins itself, and
    threads it to every worker spawn: a worker respawned by the fleet
    supervisor inherits the (already-pinned) parent's affinity mask,
    so reading ``sched_getaffinity`` in the child would see only the
    parent's stripe and either refuse placement or pile every respawn
    onto worker 0's cores. ``None`` falls back to this process's own
    inherited mask (the pre-pin spawn path and standalone use)."""
    getter = getattr(os, "sched_getaffinity", None)
    setter = getattr(os, "sched_setaffinity", None)
    if setter is None:
        return None
    if cpus is not None:
        allowed = set(cpus)
    else:
        if getter is None:
            return None
        try:
            allowed = getter(0)
        except OSError:
            return None
    stripe = assign_worker_cpus(index, total, allowed)
    if stripe is None:
        logger.debug(
            "worker %d/%d: no affinity stripe (%d allowed cpus) — "
            "leaving scheduling to the kernel", index, total, len(allowed))
        return None
    try:
        setter(0, stripe)
    except OSError as exc:                 # containers may deny the call
        logger.debug("worker %d/%d: sched_setaffinity(%s) denied: %s",
                     index, total, sorted(stripe), exc)
        return None
    logger.info("worker %d/%d pinned to cpus %s", index, total,
                sorted(stripe))
    return stripe
