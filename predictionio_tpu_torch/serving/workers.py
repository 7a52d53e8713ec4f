"""Cross-worker coherence for the prefork engine-serving pool (a copy of
the JAX package's ``serving/workers.py``; ``pio deploy --workers N``).

N worker processes share one ``SO_REUSEPORT`` listen port, each with its
own model replica on the card, its own batcher, cache and metric
registry. The kernel spreads connections across them, which makes every
*admin* request a 1/N lottery: a ``POST /reload`` lands on ONE worker and
the other N-1 would keep serving the old model and the old cache
generation.

This module rides the worker spool
(:class:`~predictionio_tpu_torch.fleet.workers.WorkerHub`) to make admin
state **eventually coherent across the pool** without a coordinator:

- the spool's ``admin.state`` document holds a CUMULATIVE state, not an
  action log: ``{"seq": N, "reloadSeq": R, "draining": bool,
  "retrieval": {...}|null}``, so a respawned worker adopts the whole
  current state from one read;
- a mutation (``/reload`` succeeded, ``/drain`` latched, retrieval
  reconfigured) merges its change into the current document and
  publishes it with the next sequence number;
- every sibling's sync loop applies a document whose ``seq`` is past the
  one it applied last, by DELTA against its last-applied state:
  ``reloadSeq`` advanced → reload (adopting the sequence number as the
  result-cache generation, so every cache lands on the SAME generation);
  ``draining`` flipped → flip the local latch; ``retrieval`` changed →
  reconfigure the local models.

Concurrent publishers race last-writer-wins on the ``os.replace``; the
merge-before-publish read keeps a sibling's earlier mutation in the
published document, and :meth:`WorkerCoherence.publish` fires the apply
callback for any sibling delta it carried forward.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable

from predictionio_tpu_torch.fleet.workers import WorkerHub

logger = logging.getLogger(__name__)

#: the cumulative admin-state schema (module docstring); ``seq`` and
#: ``publishedBy`` are stamped by WorkerHub.publish_admin
DEFAULT_STATE = {"reloadSeq": 0, "draining": False, "retrieval": None}


def _normalize(doc: dict | None) -> dict:
    """The cumulative state fields of ``doc`` with schema defaults for
    anything missing/malformed — a junk document degrades to defaults
    instead of wedging the sync loop."""
    out = dict(DEFAULT_STATE)
    if not isinstance(doc, dict):
        return out
    if isinstance(doc.get("reloadSeq"), int) and doc["reloadSeq"] >= 0:
        out["reloadSeq"] = doc["reloadSeq"]
    if isinstance(doc.get("draining"), bool):
        out["draining"] = doc["draining"]
    if isinstance(doc.get("retrieval"), dict) or doc.get("retrieval") is None:
        out["retrieval"] = doc.get("retrieval")
    return out


class WorkerCoherence:
    """One worker's view of the shared admin state: publish mutations,
    apply siblings' (module docstring).

    ``on_state(new, prev)`` is the apply callback — the engine service
    compares the two cumulative states and performs whatever changed
    (reload / drain latch / retrieval reconfig). It runs on the sync
    thread or the publishing handler thread, never under this object's
    lock, and must tolerate being called concurrently with overlapping
    deltas (the service's reload path already does — concurrent HTTP
    ``/reload`` calls were always possible)."""

    def __init__(self, hub: WorkerHub,
                 on_state: Callable[[dict, dict], None],
                 interval_s: float = 0.5):
        self.hub = hub
        self._on_state = on_state
        self._interval_s = interval_s
        self._lock = threading.Lock()
        self._seq = 0
        self._state = dict(DEFAULT_STATE)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- adoption at (re)spawn ------------------------------------------------
    def adopt(self) -> dict:
        """Read the current document and mark it applied WITHOUT firing
        the callback — the caller decides what a fresh boot needs (a
        respawned worker already loaded the latest completed instance,
        so it adopts ``reloadSeq`` as history rather than reloading;
        the drain latch and retrieval config it applies itself).
        Returns the adopted cumulative state."""
        doc = self.hub.read_admin()
        with self._lock:
            if doc is not None:
                self._seq = doc["seq"]
                self._state = _normalize(doc)
            return dict(self._state)

    def state(self) -> dict:
        with self._lock:
            return dict(self._state)

    def next_reload_seq(self) -> int:
        """The reload sequence a /reload happening NOW should commit
        as: one past the latest the spool or this worker has seen (the
        spool may be ahead of the local state when a sibling's publish
        has not been synced yet)."""
        doc = _normalize(self.hub.read_admin())
        with self._lock:
            return max(doc["reloadSeq"], self._state["reloadSeq"]) + 1

    # -- publish --------------------------------------------------------------
    def publish(self, **changes) -> dict:
        """Merge ``changes`` into the current spool document, publish
        with the next sequence number, and mark the result applied.
        The published document may carry a sibling mutation this worker
        has not applied yet (its sync loop simply had not run); those
        deltas fire the apply callback here so carrying them forward
        never swallows them. The caller has already performed its OWN
        change before publishing — a failed local mutation must not be
        announced to the pool."""
        with self._lock:
            current = _normalize(self.hub.read_admin())
            prev = self._state
            merged = {**current, **changes}
            try:
                seq = self.hub.publish_admin(merged)
            except OSError:
                logger.exception("publishing serving admin state failed")
                return dict(prev)
            self._seq = max(self._seq, seq)
            self._state = merged
            # sibling deltas the merge carried forward: everything that
            # differs between our last-applied state and the published
            # document EXCEPT the change we just made ourselves
            already = {**prev, **changes}
        if merged != already:
            self._on_state(dict(merged), dict(already))
        return dict(merged)

    # -- sync -----------------------------------------------------------------
    def sync_once(self) -> bool:
        """Apply the spool document when its sequence advanced past
        what this worker last applied; returns True when a delta was
        handed to the callback."""
        doc = self.hub.read_admin()
        if doc is None:
            return False
        with self._lock:
            if doc["seq"] <= self._seq:
                return False
            self._seq = doc["seq"]
            prev = self._state
            self._state = _normalize(doc)
            new = self._state
        self._on_state(dict(new), dict(prev))
        return True

    def _run(self) -> None:
        # Event.wait doubles as the interval sleep and a prompt stop
        while not self._stop.wait(self._interval_s):
            try:
                self.sync_once()
            except Exception:  # noqa: BLE001 — a torn read is the next pass's problem
                logger.exception("serving admin-state sync failed")

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="pio-serving-admin-sync", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
