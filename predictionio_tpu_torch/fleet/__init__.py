"""The fleet tier (a copy of the JAX package's ``fleet/``): a thin router
process fronting N engine-server replicas, and the process discipline
of the pools under it. None of it imports torch: the router never
touches the card.

- ``membership.py``: health-driven membership, every backend's
  ``/healthz`` + ``/readyz`` probed on a background loop with
  mark-down/mark-up hysteresis;
- ``canary.py``: weighted canary rollout with guardrail auto-abort;
- ``router.py``: the routing core, a circuit breaker per backend, one
  retry on a *different* healthy replica, optional tail-latency hedging,
  bounded in-flight admission, ``X-PIO-Deadline-Ms`` propagation;
- ``gateway.py``: N named engine groups behind one router, with quotas
  and burst credits per engine;
- ``controller.py``: the scale controller and the capacity arbiter;
- ``supervisor.py``: respawns dead children (``pio router --supervise``
  replicas, ``pio deploy --workers N --supervise`` siblings);
- ``workers.py`` and ``transport.py``: the worker pool's peering and the
  lean loopback client, which the router's forward path uses too.

The HTTP surface is ``api/router_server.py`` (``pio router``).
"""

from predictionio_tpu_torch.fleet.canary import CanaryController, GuardrailConfig
from predictionio_tpu_torch.fleet.gateway import (
    EngineGateway,
    EngineGroup,
    EngineQuota,
    EngineSpec,
)
from predictionio_tpu_torch.fleet.membership import (
    DOWN,
    UP,
    Backend,
    BackendSpec,
    FleetMembership,
)
from predictionio_tpu_torch.fleet.router import (
    AdmissionGate,
    FleetRouter,
    HedgePolicy,
    RouterConfig,
    RouterResponse,
)
from predictionio_tpu_torch.fleet.stats import RouterStats

__all__ = [
    "AdmissionGate",
    "Backend",
    "BackendSpec",
    "CanaryController",
    "DOWN",
    "EngineGateway",
    "EngineGroup",
    "EngineQuota",
    "EngineSpec",
    "FleetMembership",
    "FleetRouter",
    "GuardrailConfig",
    "HedgePolicy",
    "RouterConfig",
    "RouterResponse",
    "RouterStats",
    "UP",
]
