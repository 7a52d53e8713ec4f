"""Event Server REST API, stats, webhooks, plugins; the engine server."""

from predictionio_tpu_torch.api.event_server import EventServer, EventServerConfig, EventService

__all__ = ["EventServer", "EventServerConfig", "EventService"]
