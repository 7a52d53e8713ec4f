"""Event-server plugin framework (a copy of the JAX package's
``api/plugins.py``; the engine server's plugins live in
``api/engine_server.py``).

Parity: data/src/main/scala/.../data/api/{EventServerPlugin.scala:20-36,
EventServerPluginContext.scala,PluginsActor.scala} — plugins are either
input *blockers* (run synchronously before insert; may raise to reject the
event) or input *sniffers* (observe asynchronously after insert). The
reference discovers plugins via java.util.ServiceLoader; here they are
passed in explicitly or registered via ``register_plugin`` (the
entry-point-registry equivalent, per SURVEY.md §7's translation table).
"""

from __future__ import annotations

import abc
import dataclasses
import logging
import queue
import threading

from predictionio_tpu_torch.core.event import Event

logger = logging.getLogger(__name__)

INPUT_BLOCKER = "inputblocker"
INPUT_SNIFFER = "inputsniffer"


@dataclasses.dataclass(frozen=True)
class EventInfo:
    """Parity: EventInfo (EventServerPlugin.scala:34-36)."""
    app_id: int
    channel_id: int | None
    event: Event


class EventServerPlugin(abc.ABC):
    """Parity: EventServerPlugin (EventServerPlugin.scala:20-32)."""

    plugin_name: str = "plugin"
    plugin_description: str = ""
    plugin_type: str = INPUT_SNIFFER

    @abc.abstractmethod
    def process(self, event_info: EventInfo, context: "EventServerPluginContext") -> None:
        """Blockers: raise to reject the event. Sniffers: observe only."""


class EventServerPluginContext:
    """Plugin bookkeeping + async dispatch to sniffers.

    Parity: EventServerPluginContext.scala (plugin maps) + PluginsActor
    (async sniffer fan-out). The actor becomes a daemon worker thread
    draining a queue.
    """

    def __init__(self, plugins: list[EventServerPlugin] | None = None):
        plugins = list(plugins or []) + list(_REGISTERED_PLUGINS)
        self.input_blockers = {
            p.plugin_name: p for p in plugins if p.plugin_type == INPUT_BLOCKER
        }
        self.input_sniffers = {
            p.plugin_name: p for p in plugins if p.plugin_type == INPUT_SNIFFER
        }
        self._queue: "queue.Queue[EventInfo | None]" = queue.Queue()
        self._worker: threading.Thread | None = None
        if self.input_sniffers:
            self._worker = threading.Thread(
                target=self._drain, name="pio-plugin-sniffers", daemon=True
            )
            self._worker.start()

    def _drain(self) -> None:
        while True:
            info = self._queue.get()
            if info is None:
                return
            for sniffer in self.input_sniffers.values():
                try:
                    sniffer.process(info, self)
                except Exception:
                    logger.exception("sniffer %s failed", sniffer.plugin_name)

    def run_blockers(self, info: EventInfo) -> None:
        """Synchronous; exceptions propagate and reject the event
        (EventServer.scala:276-280)."""
        for blocker in self.input_blockers.values():
            blocker.process(info, self)

    def notify_sniffers(self, info: EventInfo) -> None:
        """Async; fire-and-forget (EventServer.scala:282-285)."""
        if self._worker is not None:
            self._queue.put(info)

    def describe(self) -> dict:
        """The /plugins.json payload (EventServer.scala:157-177)."""
        def block(plugins: dict[str, EventServerPlugin]) -> dict:
            return {
                name: {
                    "name": p.plugin_name,
                    "description": p.plugin_description,
                    "class": type(p).__qualname__,
                }
                for name, p in plugins.items()
            }

        return {
            "plugins": {
                "inputblockers": block(self.input_blockers),
                "inputsniffers": block(self.input_sniffers),
            }
        }

    def close(self) -> None:
        if self._worker is not None:
            self._queue.put(None)
            self._worker.join(timeout=5)
            self._worker = None


_REGISTERED_PLUGINS: list[EventServerPlugin] = []


def register_plugin(plugin: EventServerPlugin) -> None:
    """Process-wide plugin registration (ServiceLoader equivalent)."""
    _REGISTERED_PLUGINS.append(plugin)
