"""Deployment: load a trained engine instance and answer queries (port of
the query path of the JAX package's ``workflow/deploy.py``).

``load_deployed_engine(storage, config)`` looks up the engine instance
(by id, else the latest COMPLETED one of the configured engine and
variant), rebuilds its params from the instance row, reads and checks
its model blob (``workflow/persistence.py``) and restores the models
with ``Engine.prepare_deploy`` onto the configured device, on the same
algorithm instances that then serve. A deployed engine keeps its models
resident on the device between requests.

A model directory, as the templates' ``save_engine_model`` /
``ALSModel.save`` write it, deploys without storage through
``ServerConfig.model_dir`` (:func:`load_model_dir`): the engine server's
``--model-dir`` entry.

``ServerConfig`` also carries the serving layer's knobs (micro-batching,
the result cache and its shared-memory segment, the request deadline,
the server key, the retrieval mode and its ANN knobs), the worker
pool's and the online freshness plane's; each default reads its
``PIO_SERVING_<KEY>`` or ``PIO_ONLINE_<KEY>`` variable when the config is
built (``utils/envcfg.py``), as in the JAX package. The retrieval knobs are applied
to every ALS-family model on each load (:func:`apply_retrieval_config`).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Sequence

import torch

from predictionio_tpu_torch.controller.base import PersistentModelManifest
from predictionio_tpu_torch.controller.engine import Engine, resolve_engine_factory
from predictionio_tpu_torch.controller.params import EngineParams
from predictionio_tpu_torch.storage.base import EngineInstance
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.envcfg import env_field
from predictionio_tpu_torch.workflow.context import EngineContext
from predictionio_tpu_torch.workflow.persistence import load_models

logger = logging.getLogger(__name__)

DEFAULT_ENGINE_FACTORY = "predictionio_tpu_torch.templates.sessionrec.engine_factory"


def _env_field(key: str, default: Any, cast: Callable[[str], Any]):
    """A ``PIO_SERVING_<KEY>``-overridable default."""
    return env_field("PIO_SERVING_", key, default, cast)


def _online_field(key: str, default: Any, cast: Callable[[str], Any]):
    """A ``PIO_ONLINE_<KEY>``-overridable default of the freshness plane."""
    return env_field("PIO_ONLINE_", key, default, cast)


def _cast_bool(raw: str) -> bool:
    return raw.strip().lower() in ("1", "true", "yes", "on")


def _cast_policy(raw: str) -> str:
    # validated here, so a misspelt value falls back to the default
    value = raw.strip().lower()
    if value not in ("adaptive", "fixed"):
        raise ValueError(value)
    return value


def _cast_retrieval(raw: str) -> str:
    # validated here, so a misspelt value serves brute force with a warning
    value = raw.strip().lower()
    if value not in ("brute", "ann"):
        raise ValueError(value)
    return value


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """The JAX package's ``ServerConfig`` fields that this port serves,
    plus the device. Under ``--workers N`` every worker of the pool gets
    the same config (and so the same device), with its own
    ``worker_index``; the config pickles, since a sibling is started
    from the ``spawn`` context."""

    ip: str = "0.0.0.0"
    port: int = 8000              # 0 binds a free port (``EngineServer.port``)
    engine_instance_id: str | None = None
    #: the engine.json identity (``id``/``version``/``variantId``); with
    #: none of them the latest COMPLETED instance of any engine deploys
    engine_id: str | None = None
    engine_version: str | None = None
    engine_variant: str | None = None
    device: str | None = None     # None → cuda
    #: deploy a model directory instead of a stored instance
    model_dir: str | None = None
    #: the engine of a ``model_dir`` deploy (a stored instance names its own)
    engine_factory: str = DEFAULT_ENGINE_FACTORY
    #: feedback loop: POST each (query, prediction) to the event server
    #: as a ``predict`` event of entity type ``pio_pr``
    feedback: bool = False
    event_server_ip: str = "0.0.0.0"
    event_server_port: int = 7070
    access_key: str = ""
    #: socket timeout of the fire-and-forget feedback POST: bounds how
    #: long a stalled event server can hold a feedback thread
    feedback_timeout_s: float = 10.0
    #: when set, /stop and /reload require ?accessKey=<server_key>
    server_key: str | None = None
    #: micro-batching: concurrent queries coalesce into one
    #: ``DeployedEngine.query_batch`` (serving/batcher.py)
    batching: bool = _env_field("BATCHING", False, _cast_bool)
    #: "adaptive" (EWMA-driven wait) or "fixed" (a constant window)
    batch_policy: str = _env_field("BATCH_POLICY", "adaptive", _cast_policy)
    batch_max: int = _env_field("BATCH_MAX", 64, int)
    #: adaptive: the cap on the coalescing wait; fixed: the window
    batch_wait_ms: float = _env_field("BATCH_WAIT_MS", 5.0, float)
    #: result cache (serving/result_cache.py): LRU + TTL over canonical
    #: query JSON, invalidated on /reload. Only for engines whose answer
    #: depends on nothing but the query and the deployed model
    cache_enabled: bool = _env_field("CACHE_ENABLED", False, _cast_bool)
    cache_max_entries: int = _env_field("CACHE_MAX_ENTRIES", 4096, int)
    cache_ttl_s: float = _env_field("CACHE_TTL_S", 30.0, float)
    #: back the result cache with ONE shared-memory segment that every
    #: worker of the pool attaches (serving/shm_cache.py): a key warmed
    #: by any worker is a hit for its siblings, and a /reload re-warms
    #: once. Needs ``cache_enabled``; where POSIX shared memory fails
    #: the worker warns and keeps a private cache
    shm_cache: bool = _env_field("SHM", False, _cast_bool)
    #: slots of the direct-mapped table (colliding keys overwrite)
    shm_slots: int = _env_field("SHM_SLOTS", 4096, int)
    #: bytes a slot: header, canonical key and pickled prediction; a
    #: larger entry stays uncached
    shm_slot_bytes: int = _env_field("SHM_SLOT_BYTES", 4096, int)
    #: the pool's segment name (the deploy command creates and owns
    #: one); empty: a private per-process segment
    shm_segment: str = _env_field("SHM_SEGMENT", "", str)
    #: per-request time budget for /queries.json (0: none); a client may
    #: lower it with an X-PIO-Deadline-Ms header; a blown budget answers
    #: 503 + Retry-After
    request_deadline_ms: float = _env_field("REQUEST_DEADLINE_MS", 0.0, float)
    #: "brute" scores the whole item table per query; "ann" probes the
    #: IVF index saved beside the model (built at deploy when missing)
    #: and rescores the shortlist exactly (ops/ann.py). Applies to every
    #: model with ``configure_retrieval`` (the ALS family); others ignore it
    retrieval: str = _env_field("RETRIEVAL", "brute", _cast_retrieval)
    #: IVF cell count of a deploy-time build (0: auto, ~4*sqrt(catalog))
    ann_nlist: int = _env_field("ANN_NLIST", 0, int)
    #: cells probed per query (0: auto, nlist/64 floored at 16)
    ann_nprobe: int = _env_field("ANN_NPROBE", 0, int)
    #: cap on the candidates rescored per query (0: every probed one)
    ann_rescore: int = _env_field("ANN_RESCORE", 0, int)
    #: the freshness plane (online/): tail the event store between
    #: retrains and fold touched users' ALS vectors into the deployed
    #: model. ALS-family engines only; others warn and serve batch-only
    online: bool = _online_field("ENABLED", False, _cast_bool)
    #: tail polling interval: the floor of the freshness lag
    online_interval_s: float = _online_field("INTERVAL_S", 1.0, float)
    #: at most this many folded users in the overlay (items: a quarter);
    #: LRU-evicted users fall back to their base vector
    online_overlay_max: int = _online_field("OVERLAY_MAX", 4096, int)
    #: directory of the durable tail cursor; empty: in memory, re-tailed
    #: from deploy time after a restart
    online_state_dir: str = _online_field("STATE_DIR", "", str)
    #: per-request spans for /queries.json, served on GET /traces.json;
    #: None defers to the PIO_TRACE env var at server construction. Off
    #: by default: the disabled path is one flag check per request
    tracing: bool | None = None
    #: the prefork pool (``pio deploy --workers N``): N engine-server
    #: processes on ONE ``SO_REUSEPORT`` port, each with its own CUDA
    #: context, model replica, batcher, cache and registry (one CPython
    #: process is bound by its GIL long before the card is busy)
    workers: int = _env_field("WORKERS", 1, int)
    #: the spool directory of worker peering and shared admin state
    #: (fleet/workers.WorkerHub, serving/workers.WorkerCoherence); the
    #: deploy command creates it. None: no pool
    worker_spool_dir: str | None = None
    #: this worker's ordinal (0: the deploy process itself): its
    #: CPU-affinity stripe (serving/placement.py)
    worker_index: int = 0
    #: the pool's allowed CPUs, captured before the parent pins itself
    #: to stripe 0, so that a respawned worker carves its stripe from
    #: the whole set. None: the process's own mask
    cpu_allowlist: tuple[int, ...] | None = None
    #: bind with SO_REUSEPORT (set by the deploy command for a pool;
    #: never derived from ``workers``, which the environment can set)
    reuse_port: bool = False
    #: socket bound of each sibling fetch when /metrics, /stats.json or
    #: /traces.json fold the pool: a wedged worker costs its timeout
    worker_peer_timeout_s: float = _env_field("WORKER_PEER_TIMEOUT_S", 2.0, float)
    #: cadence of the shared admin-state sync: a /reload, /drain or
    #: retrieval change landing on any worker reaches every sibling
    #: within about this many seconds
    admin_sync_interval_s: float = _env_field("ADMIN_SYNC_INTERVAL_S", 0.5, float)


class DeployedEngine:
    """A loaded engine ready to serve queries."""

    def __init__(
        self,
        engine: Engine,
        instance_id: str,
        algorithms: Sequence[Any],
        serving: Any,
        models: Sequence[Any],
        device: torch.device,
        instance: EngineInstance | None = None,
    ):
        self.engine = engine
        self.instance_id = instance_id
        self.instance = instance
        self.algorithms = list(algorithms)
        self.serving = serving
        self.models = list(models)
        self.device = device
        self.start_time = time.time()
        self._stats_lock = threading.Lock()
        self.request_count = 0
        self.avg_serving_sec = 0.0
        self.last_serving_sec = 0.0

    @property
    def query_class(self) -> type | None:
        for component in [*self.algorithms, self.serving]:
            qc = getattr(component, "query_class", None)
            if qc is not None:
                return qc
        return None

    def query(self, query: Any) -> Any:
        """supplement → each algorithm's predict → serve."""
        t0 = time.perf_counter()
        supplemented = self.serving.supplement(query)
        predictions = [
            algo.predict(model, supplemented)
            for algo, model in zip(self.algorithms, self.models)
        ]
        served = self.serving.serve(query, predictions)
        self.record_served(time.perf_counter() - t0)
        return served

    def query_batch(self, queries: Sequence[Any]) -> list[Any]:
        """N queries through each algorithm's ``batch_predict`` (one
        batched device call per algorithm), then served one by one."""
        t0 = time.perf_counter()
        supplemented = [self.serving.supplement(q) for q in queries]
        indexed = list(enumerate(supplemented))
        per_algo = [dict(algo.batch_predict(model, indexed))
                    for algo, model in zip(self.algorithms, self.models)]
        served = [
            self.serving.serve(q, [preds[i] for preds in per_algo])
            for i, q in enumerate(queries)
        ]
        dt = time.perf_counter() - t0
        for _ in queries:           # bookkeeping counts every query
            self.record_served(dt)
        return served

    def record_served(self, dt: float) -> None:
        with self._stats_lock:
            self.request_count += 1
            self.avg_serving_sec += (dt - self.avg_serving_sec) / self.request_count
            self.last_serving_sec = dt


def retrieval_targets(models: Sequence[Any]):
    """The models a deployment's retrieval knobs apply to: those with
    ``configure_retrieval`` (ALSModel) or with it on an ``als`` attribute
    (the similar-product and e-commerce models)."""
    for model in models:
        if hasattr(model, "configure_retrieval"):
            yield model
        elif hasattr(getattr(model, "als", None), "configure_retrieval"):
            yield model.als


def apply_retrieval_config(models: Sequence[Any], config: ServerConfig) -> None:
    """Push the retrieval knobs onto every capable model (none: a no-op)."""
    for target in retrieval_targets(models):
        target.configure_retrieval(config.retrieval, nprobe=config.ann_nprobe,
                                   rescore=config.ann_rescore, nlist=config.ann_nlist)


def resolve_engine_instance(storage: Storage, config: ServerConfig) -> EngineInstance:
    """By id when given, else the latest COMPLETED instance matching
    (engine_id, engine_version, engine_variant), else the latest
    COMPLETED one of any engine."""
    instances = storage.get_meta_data_engine_instances()
    if config.engine_instance_id:
        instance = instances.get(config.engine_instance_id)
        if instance is None:
            raise LookupError(f"engine instance {config.engine_instance_id!r} not found")
        return instance
    if config.engine_id is not None:
        instance = instances.get_latest_completed(
            config.engine_id, config.engine_version or "1",
            config.engine_variant or config.engine_id)
    else:
        completed = [i for i in instances.get_all() if i.status == "COMPLETED"]
        instance = max(completed, key=lambda i: i.start_time, default=None)
    if instance is None:
        raise LookupError(
            "no completed engine instance found; run `pio train` first "
            f"(engine_id={config.engine_id}, variant={config.engine_variant!r})")
    return instance


def load_deployed_engine(
    storage: Storage | None = None,
    config: ServerConfig | None = None,
    ctx: EngineContext | None = None,
    engine: Engine | None = None,
) -> DeployedEngine:
    """The engine instance ``config`` names (see
    :func:`resolve_engine_instance`), its models restored on
    ``config.device`` (default ``cuda``); ``ctx`` defaults to one on that
    device over ``storage`` (default ``Storage()`` from the
    environment). A ``config.model_dir`` deploys that directory instead
    (:func:`load_model_dir`). The algorithms that load the models are
    the ones that serve them. The retrieval knobs are applied on every
    load, ``/reload`` included: the mode is deployment config, not model
    data."""
    config = config if config is not None else ServerConfig()
    if config.model_dir is not None:
        deployed = load_model_dir(config.model_dir, engine_factory=config.engine_factory,
                                  device=config.device)
        apply_retrieval_config(deployed.models, config)
        return deployed
    storage = storage or (ctx.storage if ctx is not None else Storage())
    ctx = ctx or EngineContext(storage=storage, device=config.device)
    instance = resolve_engine_instance(storage, config)
    if engine is None:
        engine = resolve_engine_factory(instance.engine_factory)()
    engine_params = engine.params_from_instance_json(
        instance.data_source_params, instance.preparator_params,
        instance.algorithms_params, instance.serving_params)
    persisted = load_models(storage, instance.id, ctx.device)
    _, _, algorithms, serving = engine.make_components(engine_params)
    models = engine.prepare_deploy(ctx, engine_params, persisted, algorithms=algorithms)
    apply_retrieval_config(models, config)
    logger.info("deployed engine instance %s (%s; %d algorithm(s)) on %s",
                instance.id, instance.engine_factory, len(algorithms), ctx.device)
    return DeployedEngine(engine, instance.id, algorithms, serving, models, ctx.device,
                          instance)


def load_model_dir(
    model_dir: str,
    engine_params: EngineParams | None = None,
    *,
    engine_factory: str = DEFAULT_ENGINE_FACTORY,
    device: str | torch.device | None = None,
) -> DeployedEngine:
    """The engine ``engine_factory`` names, built from ``engine_params``
    (default: its first algorithm with default params), serving the
    model saved in ``model_dir`` — or in ``model_dir/<i>`` for algorithm
    i of several — on ``device`` (default ``cuda``): each directory
    loads as a manifest through its algorithm's ``load_model``."""
    ctx = EngineContext(device=device)
    engine = resolve_engine_factory(engine_factory)()
    if engine_params is None:
        name = next(iter(engine.algorithm_class_map))
        engine_params = engine.params_from_instance_json(
            "", "", json.dumps([{"name": name, "params": {}}]), "")
    _, _, algorithms, serving = engine.make_components(engine_params)
    dirs = ([model_dir] if len(algorithms) == 1 else
            [os.path.join(model_dir, str(i)) for i in range(len(algorithms))])
    manifests = [PersistentModelManifest(f"{type(a).__module__}.{type(a).__qualname__}", d)
                 for a, d in zip(algorithms, dirs)]
    models = engine.prepare_deploy(ctx, engine_params, manifests, algorithms=algorithms)
    logger.info("deployed %s from %s on %s (%d algorithm(s))",
                engine_factory, model_dir, ctx.device, len(algorithms))
    return DeployedEngine(engine, os.path.abspath(model_dir), algorithms, serving, models,
                          ctx.device)
