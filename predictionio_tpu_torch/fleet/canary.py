"""Weighted canary rollout with guardrail auto-abort (a copy of the JAX
package's ``fleet/canary.py``).

A new model generation deploys to the ``canary`` replica group; the
router sends ``weight_pct`` percent of queries there and watches a
sliding window of canary outcomes. When the window holds at least
``min_requests`` samples and either the error rate or the p99 latency
breaches its guardrail, the canary AUTO-ABORTS: weight snaps to zero,
the abort is latched (with its reason) until an operator sets a new
weight, and stable serves everything — a bad rollout degrades to the
previous generation, it does not take the fleet down.

Trustworthiness note: canary-vs-stable only means anything when the two
groups really serve the generations they claim — that is what the
crash-safe checkpoint manifest and the checksummed model envelope
(utils/checkpoint.py, workflow/persistence.py) guarantee at load time.

All state sits under one lock (writers: handler threads recording
outcomes, the admin endpoint; readers: routing picks, snapshots).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import random
import threading
from collections import deque

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class GuardrailConfig:
    """When to pull the plug on a canary."""

    #: no verdict before this many canary samples are in the window —
    #: a single unlucky first request must not abort a rollout
    min_requests: int = 20
    #: abort when window error rate exceeds this (0..1); <=0 disables
    max_error_rate: float = 0.5
    #: abort when window p99 exceeds this many ms; <=0 disables
    max_p99_ms: float = 0.0
    #: sliding window length (newest N canary outcomes)
    window: int = 200


class CanaryController:
    """Traffic split + guardrail evaluation (module docstring)."""

    def __init__(self, weight_pct: float = 0.0,
                 guardrail: GuardrailConfig | None = None,
                 rng: random.Random | None = None):
        self.guardrail = guardrail or GuardrailConfig()
        self._lock = threading.Lock()
        self._weight_pct = min(100.0, max(0.0, weight_pct))
        self._window: deque[tuple[bool, float]] = deque(
            maxlen=max(1, self.guardrail.window))
        self._aborted = False
        self._abort_reason: str | None = None
        self._aborts = 0
        #: seeded in tests for a deterministic split
        self._rng = rng or random.Random()

    # -- routing ------------------------------------------------------------
    def pick_group(self) -> str:
        """``canary`` for weight_pct% of calls, else ``stable``."""
        with self._lock:
            weight = self._weight_pct
            if weight <= 0.0:
                return "stable"
            return "canary" if self._rng.random() * 100.0 < weight \
                else "stable"

    @property
    def weight_pct(self) -> float:
        with self._lock:
            return self._weight_pct

    @property
    def aborted(self) -> bool:
        with self._lock:
            return self._aborted

    # -- outcome feed + guardrail -------------------------------------------
    def record(self, group: str, ok: bool, latency_s: float) -> bool:
        """Fold one routed outcome in; returns True when THIS sample
        tripped the guardrail (the caller counts/logs the abort)."""
        if group != "canary":
            return False
        with self._lock:
            self._window.append((ok, latency_s))
            if self._aborted or self._weight_pct <= 0.0:
                return False
            reason = self._breach_locked()
            if reason is None:
                return False
            self._weight_pct = 0.0
            self._aborted = True
            self._abort_reason = reason
            self._aborts += 1
        logger.warning("canary auto-abort: %s", reason)
        return True

    def _breach_locked(self) -> str | None:
        g = self.guardrail
        n = len(self._window)
        if n < max(1, g.min_requests):
            return None
        errors = sum(1 for ok, _ in self._window if not ok)
        if g.max_error_rate > 0 and errors / n > g.max_error_rate:
            return (f"error rate {errors}/{n} = {errors / n:.2f} "
                    f"> {g.max_error_rate:.2f} over the last {n} requests")
        if g.max_p99_ms > 0:
            lat = sorted(l for _, l in self._window)
            # upper-index convention (ceil(q*n)-1): at window sizes
            # near min_requests the p99 must see the max, not the
            # second-largest
            p99 = lat[min(n - 1, math.ceil(0.99 * n) - 1)] * 1e3
            if p99 > g.max_p99_ms:
                return (f"p99 {p99:.1f}ms > {g.max_p99_ms:.1f}ms "
                        f"over the last {n} requests")
        return None

    # -- operator surface ---------------------------------------------------
    def set_weight(self, weight_pct: float,
                   guardrail: GuardrailConfig | None = None) -> None:
        """Start (or resize) a rollout: clears a previous abort latch
        and the outcome window — a NEW generation must not inherit the
        failed one's verdict."""
        with self._lock:
            if guardrail is not None:
                self.guardrail = guardrail
                self._window = deque(maxlen=max(1, guardrail.window))
            self._weight_pct = min(100.0, max(0.0, weight_pct))
            self._aborted = False
            self._abort_reason = None
            self._window.clear()

    def abort(self, reason: str = "operator abort") -> None:
        with self._lock:
            self._weight_pct = 0.0
            self._aborted = True
            self._abort_reason = reason
            self._aborts += 1

    # -- shared-admin-state round-trip (fleet/gateway.py) --------------------
    def state_doc(self) -> dict:
        """The controller's rollout state as a JSON-able document for
        the worker-pool admin spool: weight, abort latch (+reason), and
        the guardrail — everything a sibling (or a respawned worker)
        needs to adopt this controller's verdict."""
        with self._lock:
            g = self.guardrail
            return {
                "weight": self._weight_pct,
                "aborted": self._aborted,
                "abortReason": self._abort_reason,
                "guardrail": {
                    "minRequests": g.min_requests,
                    "maxErrorRate": g.max_error_rate,
                    "maxP99Ms": g.max_p99_ms,
                    "window": g.window,
                },
            }

    def adopt_state(self, doc: dict) -> bool:
        """Diff-apply a sibling's :meth:`state_doc`: only an ACTUAL
        difference mutates (``set_weight`` clears the guardrail outcome
        window, so re-applying an identical document on every admin
        sync pass would reset the window forever and the guardrail
        could never accumulate a verdict). Returns True when something
        changed. Malformed documents are ignored — a torn or hostile
        spool entry must never take the canary down."""
        try:
            weight = float(doc["weight"])
            aborted = bool(doc["aborted"])
        except (KeyError, TypeError, ValueError):
            logger.warning("ignoring malformed canary state doc: %r", doc)
            return False
        guardrail = None
        g = doc.get("guardrail")
        if isinstance(g, dict):
            try:
                guardrail = GuardrailConfig(
                    min_requests=int(g["minRequests"]),
                    max_error_rate=float(g["maxErrorRate"]),
                    max_p99_ms=float(g["maxP99Ms"]),
                    window=int(g["window"]))
            except (KeyError, TypeError, ValueError):
                guardrail = None
        with self._lock:
            same_guardrail = guardrail is None or guardrail == self.guardrail
            if (self._aborted == aborted
                    and self._weight_pct == weight and same_guardrail):
                return False
        if aborted:
            if guardrail is not None:
                with self._lock:
                    if guardrail != self.guardrail:
                        self.guardrail = guardrail
                        self._window = deque(
                            maxlen=max(1, guardrail.window))
            self.abort(str(doc.get("abortReason") or "sibling abort"))
        else:
            self.set_weight(weight, guardrail=guardrail)
        return True

    def snapshot(self) -> dict:
        with self._lock:
            n = len(self._window)
            errors = sum(1 for ok, _ in self._window if not ok)
            return {
                "weightPct": self._weight_pct,
                "aborted": self._aborted,
                **({"abortReason": self._abort_reason}
                   if self._abort_reason else {}),
                "aborts": self._aborts,
                "windowRequests": n,
                "windowErrors": errors,
                "guardrail": {
                    "minRequests": self.guardrail.min_requests,
                    "maxErrorRate": self.guardrail.max_error_rate,
                    "maxP99Ms": self.guardrail.max_p99_ms,
                    "window": self.guardrail.window,
                },
            }
