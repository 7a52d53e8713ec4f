"""Storage records and DAO interfaces: the subset of the JAX package's
``storage/base.py`` that the memory backend, ``EventStore.find`` and the
evaluation workflow need (apps, channels, the event filter, evaluation
instances, and their DAOs). Engine instances, access keys and the model
repository come with storage-backed ``pio train``/``pio deploy``
(ROADMAP.md queue 1 item 3).
"""

from __future__ import annotations

import abc
import dataclasses
import string
from datetime import datetime, timezone
from typing import Any, Iterator, Sequence

from predictionio_tpu_torch.core.event import Event


@dataclasses.dataclass(frozen=True)
class App:
    """An app with a unique integer id."""
    id: int
    name: str
    description: str | None = None


@dataclasses.dataclass(frozen=True)
class Channel:
    """A named event channel within an app."""
    id: int
    name: str
    appid: int

    @staticmethod
    def is_valid_name(s: str) -> bool:
        """Channel names: 1-16 chars of [a-zA-Z0-9-]."""
        allowed = set(string.ascii_letters + string.digits + "-")
        return 0 < len(s) <= 16 and all(c in allowed for c in s)


@dataclasses.dataclass(frozen=True)
class EventFilter:
    """The find() filter."""
    start_time: datetime | None = None        # inclusive
    until_time: datetime | None = None        # exclusive
    entity_type: str | None = None
    entity_id: str | None = None
    event_names: Sequence[str] | None = None
    target_entity_type: str | None | type(...) = ...  # ... = any; None = must be absent
    target_entity_id: str | None | type(...) = ...
    limit: int | None = None                  # None = all
    reversed: bool = False                    # newest first

    def __post_init__(self):
        # naive bounds are UTC, as naive event times are
        for name in ("start_time", "until_time"):
            t = getattr(self, name)
            if t is not None and t.tzinfo is None:
                object.__setattr__(self, name, t.replace(tzinfo=timezone.utc))

    def matches(self, e: Event) -> bool:
        if self.start_time is not None and e.event_time < self.start_time:
            return False
        if self.until_time is not None and e.event_time >= self.until_time:
            return False
        if self.entity_type is not None and e.entity_type != self.entity_type:
            return False
        if self.entity_id is not None and e.entity_id != self.entity_id:
            return False
        if self.event_names is not None and e.event not in self.event_names:
            return False
        if self.target_entity_type is not ... and e.target_entity_type != self.target_entity_type:
            return False
        if self.target_entity_id is not ... and e.target_entity_id != self.target_entity_id:
            return False
        return True


@dataclasses.dataclass(frozen=True)
class EvaluationInstance:
    """One row per evaluation run, with the JAX package's fields."""
    id: str
    #: INIT | EVALUATING | EVALCOMPLETED | FAILED. FAILED rows carry the
    #: error; EVALUATING is written only by the parallel grid (ROADMAP.md
    #: queue 1 item 17), which the port does not run yet
    status: str
    start_time: datetime
    completion_time: datetime
    evaluation_class: str = ""
    engine_params_generator_class: str = ""
    batch: str = ""
    env: dict[str, str] = dataclasses.field(default_factory=dict)
    #: the JAX package's mesh axes; empty on one card
    mesh_conf: dict[str, Any] = dataclasses.field(default_factory=dict)
    evaluator_results: str = ""
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""


class Events(abc.ABC):
    """Event writes and filtered reads for one backend, keyed by
    (app_id, channel_id); channel_id None is the default channel."""

    @abc.abstractmethod
    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        """Create the namespace of an app/channel."""

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        """Insert one event, returning its id."""

    @abc.abstractmethod
    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: int | None = None) -> list[str]:
        """Insert many events, returning their ids."""

    @abc.abstractmethod
    def find(self, app_id: int, channel_id: int | None = None,
             filter: EventFilter = EventFilter()) -> Iterator[Event]:
        """Filtered scan in (event time, id) order."""


class Apps(abc.ABC):
    """App metadata DAO."""

    @abc.abstractmethod
    def insert(self, app: App) -> int | None:
        """Insert; id 0 means auto-assign. Returns the assigned id."""

    @abc.abstractmethod
    def get_by_name(self, name: str) -> App | None: ...


class Channels(abc.ABC):
    """Channel DAO."""

    @abc.abstractmethod
    def insert(self, channel: Channel) -> int | None:
        """Insert; id 0 means auto-assign. Returns the assigned id."""

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> list[Channel]: ...


class EvaluationInstances(abc.ABC):
    """Evaluation-instance DAO."""

    @abc.abstractmethod
    def insert(self, instance: EvaluationInstance) -> str:
        """Insert; an empty id means auto-assign. Returns the id."""

    @abc.abstractmethod
    def get(self, instance_id: str) -> EvaluationInstance | None: ...

    @abc.abstractmethod
    def get_all(self) -> list[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_completed(self) -> list[EvaluationInstance]:
        """EVALCOMPLETED instances, newest first."""

    @abc.abstractmethod
    def update(self, instance: EvaluationInstance) -> None: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> None: ...
