"""Router hot-path counters and latency attribution (a copy of the JAX
package's ``fleet/stats.py``).

Same discipline as :class:`~predictionio_tpu_torch.api.stats.ServingStats`:
one lock guards every counter at writers AND readers (handler threads
bump, ``/metrics`` and ``/fleet`` snapshot), the latency histograms
(obs/histogram.py) each own their own lock, and the registry adapter
below runs only at scrape time.
"""

from __future__ import annotations

import threading
from typing import Any

from predictionio_tpu_torch.obs.histogram import LatencyHistogram
from predictionio_tpu_torch.obs.registry import Metric


class RouterStats:
    """Counters for the fleet router's forward path."""

    COUNTER_FIELDS = (
        # admission + outcomes; quota_throttled = per-engine token
        # bucket said no (429; fleet/gateway.py) — distinct from sheds,
        # which is the GLOBAL-pressure 503
        "requests", "sheds", "quota_throttled", "expired", "no_backend",
        # resilience events
        "retries", "upstream_errors",
        # hedging
        "hedges", "hedge_wins",
        # canary bookkeeping
        "canary_requests", "stable_requests", "canary_aborts",
        # degraded-but-correct: the picked group had no healthy replica
        # and the OTHER group answered
        "group_spills",
    )

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(self.COUNTER_FIELDS, 0)
        #: end-to-end upstream exchange time per replica group
        self.upstream_latency = {
            "stable": LatencyHistogram(),
            "canary": LatencyHistogram(),
        }

    def bump(self, field: str, n: int = 1) -> None:
        with self._lock:
            self._counts[field] += n

    def bump_request(self, group: str) -> None:
        """The admission-path double count (requests + per-group) under
        ONE lock acquisition — this runs on every routed query."""
        with self._lock:
            self._counts["requests"] += 1
            self._counts[f"{group}_requests"] += 1

    def bump_throttled(self) -> None:
        """A quota-throttled request (429, fleet/gateway.py): counted
        as a request AND a throttle under one lock acquisition — it
        never reaches the per-group admission path."""
        with self._lock:
            self._counts["requests"] += 1
            self._counts["quota_throttled"] += 1

    def count(self, field: str) -> int:
        with self._lock:
            return self._counts[field]

    def observe_upstream(self, group: str, seconds: float) -> None:
        self.upstream_latency.get(group, self.upstream_latency["stable"]) \
            .observe(seconds)

    def raw_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def snapshot(self) -> dict[str, Any]:
        from predictionio_tpu_torch.core.wire import snake_to_camel

        with self._lock:
            counts = dict(self._counts)
        return {
            **{snake_to_camel(k): v for k, v in counts.items()},
            "upstreamLatency": {
                group: hist.snapshot().summary_ms()
                for group, hist in self.upstream_latency.items()
            },
        }


def router_collector(stats: RouterStats, membership: Any,
                     canary: Any) -> Any:
    """Registry adapter (obs/registry.py): router counters, per-backend
    membership state gauge, canary weight/abort gauges, and the
    upstream latency histograms by replica group."""

    def collect() -> list[Metric]:
        out = [
            Metric(
                name=f"pio_router_{field}_total", kind="counter",
                help=f"RouterStats counter {field!r} (fleet/stats.py)",
                samples=[({}, float(value))],
            )
            for field, value in stats.raw_counts().items()
        ]
        state = Metric(
            name="pio_router_backend_up", kind="gauge",
            help="Fleet membership state per backend: 1 up, 0 down")
        inflight = Metric(
            name="pio_router_backend_inflight", kind="gauge",
            help="Requests currently forwarded to this backend")
        starved = Metric(
            name="pio_router_probe_starved_total", kind="counter",
            help="Probe timeouts ignored because the backend's data "
                 "path was demonstrably healthy (breaker closed, "
                 "recent forwarded success) — the 1s-probe-under-"
                 "saturation pitfall; see docs/fleet.md \"Healthy "
                 "fleet marked down under load\"")
        for doc in membership.snapshot():
            labels = {"backend": doc["id"], "group": doc["group"]}
            state.samples.append(
                (labels, 1.0 if doc["state"] == "up" else 0.0))
            inflight.samples.append((labels, float(doc["inflight"])))
            starved.samples.append(
                (labels, float(doc.get("probeStarved", 0))))
        out.append(state)
        out.append(inflight)
        out.append(starved)
        cs = canary.snapshot()
        out.append(Metric(
            name="pio_router_canary_weight_pct", kind="gauge",
            help="Share of traffic routed to the canary replica group",
            samples=[({}, float(cs["weightPct"]))]))
        out.append(Metric(
            name="pio_router_canary_aborted", kind="gauge",
            help="1 while the canary is guardrail-aborted, else 0",
            samples=[({}, 1.0 if cs["aborted"] else 0.0)]))
        out.append(Metric(
            name="pio_router_upstream_seconds", kind="histogram",
            help="Upstream request walltime by replica group "
                 "(connect+send+receive, retries excluded)",
            histograms=[
                ({"group": group}, hist.snapshot())
                for group, hist in stats.upstream_latency.items()
            ]))
        return out

    return collect
