"""Deployment: load a saved engine model and answer queries (port of the
query path of the JAX package's ``workflow/deploy.py``).

``load_deployed_engine`` takes a model directory and the engine's
params; the storage-backed instance lookup of ``pio deploy`` comes in a
later slice. A deployed engine keeps its models resident on the device
between requests.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Sequence

import torch

from predictionio_tpu_torch.controller.engine import Engine, resolve_engine_factory
from predictionio_tpu_torch.controller.params import EngineParams
from predictionio_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

DEFAULT_ENGINE_FACTORY = "predictionio_tpu_torch.templates.sessionrec.engine_factory"


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
    ):
        self.engine = engine
        self.instance_id = instance_id
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


def load_deployed_engine(
    model_dir: str,
    engine_params: EngineParams | None = None,
    *,
    engine_factory: str = DEFAULT_ENGINE_FACTORY,
    device: str | torch.device | None = None,
) -> DeployedEngine:
    """The engine ``engine_factory`` names, built from ``engine_params``
    (default: its first algorithm with default params), serving the
    model saved in ``model_dir`` — or in ``model_dir/<i>`` for algorithm
    i of several — on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    engine = resolve_engine_factory(engine_factory)()
    if engine_params is None:
        name = next(iter(engine.algorithm_class_map))
        engine_params = engine.params_from_instance_json(
            "", "", json.dumps([{"name": name, "params": {}}]), "")
    _, _, algorithms, serving = engine.make_components(engine_params)
    dirs = ([model_dir] if len(algorithms) == 1 else
            [os.path.join(model_dir, str(i)) for i in range(len(algorithms))])
    models = [algo.load_model(d, dev) for algo, d in zip(algorithms, dirs)]
    logger.info("deployed %s from %s on %s (%d algorithm(s))",
                engine_factory, model_dir, dev, len(algorithms))
    return DeployedEngine(engine, os.path.abspath(model_dir), algorithms,
                          serving, models, dev)
