"""Storage abstraction: metadata records and DAO interfaces (a copy of
the JAX package's ``storage/base.py``, which holds no device code).

Parity with the reference's DAO traits
(reference: data/src/main/scala/.../data/storage/{Apps,AccessKeys,Channels,
EngineInstances,EvaluationInstances,Models,LEvents,PEvents}.scala). Three
repositories sit behind these interfaces: METADATA (apps/keys/channels/
engine+evaluation instances), EVENTDATA (events), MODELDATA (model blobs).

Differences from the reference, by design:
- Async Futures (LEvents.futureInsert etc., LEvents.scala:79-215) are
  dropped: the backends here are synchronous.
- PEvents' RDD-returning reads (PEvents.scala:38-189) become
  ``Events.find(...)`` iterators and the columnar batches of
  ``Events.find_columnar`` (core/columns.py), which training reads
  through ``data/store.EventStore.scan``.
"""

from __future__ import annotations

import abc
import dataclasses
import secrets
import string
from datetime import datetime, timezone
from typing import Any, Iterable, Iterator, Sequence

from predictionio_tpu_torch.core.aggregation import AGGREGATION_EVENT_NAMES, aggregate_properties
from predictionio_tpu_torch.core.columns import EventColumns, iter_batches
from predictionio_tpu_torch.core.datamap import PropertyMap
from predictionio_tpu_torch.core.event import Event


# ---------------------------------------------------------------------------
# Metadata records
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class App:
    """An app with a unique integer id. Parity: Apps.scala:32-40."""
    id: int
    name: str
    description: str | None = None


@dataclasses.dataclass(frozen=True)
class AccessKey:
    """Access key for an app; empty ``events`` = all events allowed.
    Parity: AccessKeys.scala:35-44."""
    key: str
    appid: int
    events: Sequence[str] = ()


@dataclasses.dataclass(frozen=True)
class Channel:
    """A named event channel within an app. Parity: Channels.scala:32-48."""
    id: int
    name: str
    appid: int

    @staticmethod
    def is_valid_name(s: str) -> bool:
        """Channel names: 1-16 chars of [a-zA-Z0-9-] (Channels.scala:41-48)."""
        allowed = set(string.ascii_letters + string.digits + "-")
        return 0 < len(s) <= 16 and all(c in allowed for c in s)


@dataclasses.dataclass(frozen=True)
class EngineInstance:
    """One row per training run. Parity: EngineInstances.scala:26-60.

    ``mesh_conf`` replaces the reference's ``sparkConf`` blob: the JAX
    package records its device-mesh config there; the port, on one card,
    writes it empty.
    """
    id: str
    status: str              # INIT | COMPLETED | INTERRUPTED | FAILED
    start_time: datetime
    completion_time: datetime
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    batch: str = ""
    env: dict[str, str] = dataclasses.field(default_factory=dict)
    mesh_conf: dict[str, Any] = dataclasses.field(default_factory=dict)
    data_source_params: str = ""
    preparator_params: str = ""
    algorithms_params: str = ""
    serving_params: str = ""


@dataclasses.dataclass(frozen=True)
class EvaluationInstance:
    """One row per evaluation run. Parity: EvaluationInstances.scala:42-60."""
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
    mesh_conf: dict[str, Any] = dataclasses.field(default_factory=dict)
    evaluator_results: str = ""
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""


@dataclasses.dataclass(frozen=True)
class Model:
    """A serialized model blob keyed by engine-instance id.
    Parity: Models.scala:33-41."""
    id: str
    models: bytes


# ---------------------------------------------------------------------------
# Event query filter
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EventFilter:
    """The find() filter set shared by local and parallel reads.
    Parity: LEvents.futureFind params (LEvents.scala:188-214) and
    PEvents.find (PEvents.scala:80-103)."""
    start_time: datetime | None = None        # inclusive
    until_time: datetime | None = None        # exclusive
    entity_type: str | None = None
    entity_id: str | None = None
    event_names: Sequence[str] | None = None
    target_entity_type: str | None | type(...) = ...  # ... = any; None = must be absent
    target_entity_id: str | None | type(...) = ...
    limit: int | None = None                  # None = all; reference used -1 for all
    reversed: bool = False                    # newest first (needs entity filter in ref)

    def __post_init__(self):
        # Normalize naive bounds to UTC exactly like Event.__post_init__,
        # so every backend interprets the same filter identically.
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


# ---------------------------------------------------------------------------
# DAO interfaces
# ---------------------------------------------------------------------------

class Events(abc.ABC):
    """Event CRUD + queries for one storage backend.

    Parity: LEvents trait (LEvents.scala:40-512). Implementations are keyed
    by (app_id, channel_id); channel_id None = default channel.
    """

    @abc.abstractmethod
    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        """Create the backing table/namespace for an app/channel (LEvents.scala:53)."""

    @abc.abstractmethod
    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        """Drop all events of an app/channel (LEvents.scala:61)."""

    @abc.abstractmethod
    def close(self) -> None:
        """Release client connections (LEvents.scala:69)."""

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        """Insert one event, returning its id (LEvents.scala:79-88)."""

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: int | None = None
    ) -> list[str]:
        """Insert many events, returning ids (LEvents.scala:106-115)."""
        return [self.insert(e, app_id, channel_id) for e in events]

    @abc.abstractmethod
    def get(self, event_id: str, app_id: int, channel_id: int | None = None) -> Event | None:
        """Get event by id (LEvents.scala:131)."""

    @abc.abstractmethod
    def delete(self, event_id: str, app_id: int, channel_id: int | None = None) -> bool:
        """Delete event by id, returning whether it existed (LEvents.scala:147)."""

    @abc.abstractmethod
    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter = EventFilter(),
    ) -> Iterator[Event]:
        """Filtered scan (LEvents.futureFind, LEvents.scala:188-214)."""

    #: the granularity (µs) this backend orders equal event times at:
    #: the tail follower's cursor compares at it (online/follower.py)
    CURSOR_TIME_RESOLUTION_US = 1

    #: default ``find_columnar`` batch size — large enough that the
    #: per-batch fixed cost (vocab build, array allocation) amortizes,
    #: small enough that a batch stays cache- and memory-friendly
    COLUMNAR_BATCH_SIZE = 4096

    def find_columnar(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter = EventFilter(),
        batch_size: int = COLUMNAR_BATCH_SIZE,
    ) -> Iterator[EventColumns]:
        """Filtered scan as struct-of-arrays batches (core/columns.py):
        the training-read path of the columnar data plane (the role
        PEvents' RDD reads play in the reference, PEvents.scala:80-103).

        Contract: concatenating the yielded batches reproduces EXACTLY
        the event sequence ``find`` returns for the same filter — order,
        ties, and limit cuts included (pinned per backend by
        tests/test_torch_storage.py). This generic implementation chunks
        ``find`` through the rows->columns builder; backends with a
        cheaper native representation (memory, sqlite) override it.
        """
        return iter_batches(self.find(app_id, channel_id, filter), batch_size)

    def aggregate_properties(
        self,
        app_id: int,
        entity_type: str,
        channel_id: int | None = None,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        required: Sequence[str] | None = None,
    ) -> dict[str, PropertyMap]:
        """Aggregate $set/$unset/$delete into per-entity PropertyMaps
        (LEvents.futureAggregateProperties, LEvents.scala:215-260)."""
        events = self.find(
            app_id,
            channel_id,
            EventFilter(
                start_time=start_time,
                until_time=until_time,
                entity_type=entity_type,
                event_names=list(AGGREGATION_EVENT_NAMES),
            ),
        )
        result = aggregate_properties(events)
        if required:
            result = {
                k: v for k, v in result.items() if all(v.contains(r) for r in required)
            }
        return result

    def find_single_entity(
        self,
        app_id: int,
        entity_type: str,
        entity_id: str,
        channel_id: int | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type: str | None | type(...) = ...,
        target_entity_id: str | None | type(...) = ...,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        limit: int | None = None,
        latest: bool = True,
    ) -> Iterator[Event]:
        """Time-descending single-entity read used at serving time
        (LEvents.findSingleEntity, LEvents.scala:414-459)."""
        return self.find(
            app_id,
            channel_id,
            EventFilter(
                start_time=start_time,
                until_time=until_time,
                entity_type=entity_type,
                entity_id=entity_id,
                event_names=event_names,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id,
                limit=limit,
                reversed=latest,
            ),
        )


class Apps(abc.ABC):
    """App metadata DAO. Parity: Apps trait (Apps.scala:43-61)."""

    @abc.abstractmethod
    def insert(self, app: App) -> int | None:
        """Insert; id 0 means auto-assign. Returns assigned id."""

    @abc.abstractmethod
    def get(self, app_id: int) -> App | None: ...

    @abc.abstractmethod
    def get_by_name(self, name: str) -> App | None: ...

    @abc.abstractmethod
    def get_all(self) -> list[App]: ...

    @abc.abstractmethod
    def update(self, app: App) -> None: ...

    @abc.abstractmethod
    def delete(self, app_id: int) -> None: ...


class AccessKeys(abc.ABC):
    """Access-key DAO. Parity: AccessKeys trait (AccessKeys.scala:46-77)."""

    @abc.abstractmethod
    def insert(self, access_key: AccessKey) -> str | None:
        """Insert; empty key means generate. Returns the key."""

    @abc.abstractmethod
    def get(self, key: str) -> AccessKey | None: ...

    @abc.abstractmethod
    def get_all(self) -> list[AccessKey]: ...

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> list[AccessKey]: ...

    @abc.abstractmethod
    def update(self, access_key: AccessKey) -> None: ...

    @abc.abstractmethod
    def delete(self, key: str) -> None: ...

    @staticmethod
    def generate_key() -> str:
        """64 url-safe chars (AccessKeys.generateKey hashes a UUID to
        base64, AccessKeys.scala:68-76)."""
        return secrets.token_urlsafe(48)[:64]


class Channels(abc.ABC):
    """Channel DAO. Parity: Channels trait (Channels.scala:70-82)."""

    @abc.abstractmethod
    def insert(self, channel: Channel) -> int | None:
        """Insert; id 0 means auto-assign. Returns assigned id."""

    @abc.abstractmethod
    def get(self, channel_id: int) -> Channel | None: ...

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> list[Channel]: ...

    @abc.abstractmethod
    def delete(self, channel_id: int) -> None: ...


class EngineInstances(abc.ABC):
    """Engine-instance DAO. Parity: EngineInstances trait
    (EngineInstances.scala:69-110)."""

    @abc.abstractmethod
    def insert(self, instance: EngineInstance) -> str:
        """Insert with auto-assigned id; returns id."""

    @abc.abstractmethod
    def get(self, instance_id: str) -> EngineInstance | None: ...

    @abc.abstractmethod
    def get_all(self) -> list[EngineInstance]: ...

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> EngineInstance | None:
        """Parity: EngineInstances.getLatestCompleted (:82-88)."""
        completed = self.get_completed(engine_id, engine_version, engine_variant)
        return completed[0] if completed else None

    @abc.abstractmethod
    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]:
        """COMPLETED instances, newest startTime first (:90-96)."""

    @abc.abstractmethod
    def update(self, instance: EngineInstance) -> None: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> None: ...


class EvaluationInstances(abc.ABC):
    """Evaluation-instance DAO. Parity: EvaluationInstances trait
    (EvaluationInstances.scala:62-95)."""

    @abc.abstractmethod
    def insert(self, instance: EvaluationInstance) -> str: ...

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


class Models(abc.ABC):
    """Model-blob DAO. Parity: Models trait (Models.scala:43-60)."""

    @abc.abstractmethod
    def insert(self, model: Model) -> None: ...

    @abc.abstractmethod
    def get(self, model_id: str) -> Model | None: ...

    @abc.abstractmethod
    def delete(self, model_id: str) -> None: ...


class BaseStorageClient(abc.ABC):
    """A connection to one configured storage source.

    Parity: BaseStorageClient (Storage.scala:39-53). Backends subclass this
    and expose DAO factory methods for the repositories they support; a
    NotImplementedError mirrors the reference's reflection failure for a
    (backend, trait) pair the backend doesn't provide (e.g. localfs only
    stores models, storage/localfs/.../LocalFSModels.scala)."""

    def __init__(self, config: "StorageClientConfig"):
        self.config = config

    prefix: str = ""

    def events(self) -> Events:
        raise NotImplementedError(f"{type(self).__name__} does not support event data")

    def apps(self) -> Apps:
        raise NotImplementedError(f"{type(self).__name__} does not support metadata")

    def access_keys(self) -> AccessKeys:
        raise NotImplementedError(f"{type(self).__name__} does not support metadata")

    def channels(self) -> Channels:
        raise NotImplementedError(f"{type(self).__name__} does not support metadata")

    def engine_instances(self) -> EngineInstances:
        raise NotImplementedError(f"{type(self).__name__} does not support metadata")

    def evaluation_instances(self) -> EvaluationInstances:
        raise NotImplementedError(f"{type(self).__name__} does not support metadata")

    def models(self) -> Models:
        raise NotImplementedError(f"{type(self).__name__} does not support model data")

    def close(self) -> None:
        pass


@dataclasses.dataclass(frozen=True)
class StorageClientConfig:
    """Per-source config parsed from env (Storage.scala:78-81)."""
    parallel: bool = False
    test: bool = False
    properties: dict[str, str] = dataclasses.field(default_factory=dict)
