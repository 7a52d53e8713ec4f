"""The DASE Engine (port of the JAX package's ``controller/engine.py``):
component construction from typed params, the training pipeline and the
deploy-time model restoration (``prepare_deploy``), params
from an engine.json variant or from the JSON blobs a stored engine
instance carries, engine-factory resolution, and the evaluation
pipeline: ``eval`` trains on each fold of the data source's
``read_eval`` and serves the fold's queries, every algorithm's
``batch_predict`` aligned by query index before ``Serving.serve``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import time
from typing import Any, Callable, Iterator, Mapping, Sequence

from predictionio_tpu_torch.controller.base import (
    Algorithm,
    DataSource,
    Doer,
    PersistentModelManifest,
    Preparator,
    SanityCheck,
    Serving,
)
from predictionio_tpu_torch.controller.params import EngineParams, params_from_json
from predictionio_tpu_torch.utils.reflection import resolve_attr

logger = logging.getLogger(__name__)


class StopAfterReadInterruption(Exception):
    """Raised by :meth:`Engine.train` after the read, when asked."""


class StopAfterPrepareInterruption(Exception):
    """Raised by :meth:`Engine.train` after the prepare, when asked."""


def _sanity_check(obj: Any, name: str, enabled: bool) -> None:
    """Run sanity_check() on data classes that opt in."""
    if enabled and isinstance(obj, SanityCheck):
        logger.info("%s: running sanity check", name)
        obj.sanity_check()


@contextlib.contextmanager
def _stage(stage_seconds: dict[str, float] | None, name: str) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if stage_seconds is not None:
            stage_seconds[name] = stage_seconds.get(name, 0.0) + time.perf_counter() - t0


def serve_fold(algorithms: Sequence[Algorithm], models: Sequence[Any], serving: Serving,
               qa_pairs: Sequence[tuple[Any, Any]]) -> list[tuple[Any, Any, Any]]:
    """The (query, served, actual) triples of one evaluation fold: every
    query through ``serving.supplement``, each algorithm's
    ``batch_predict`` over the (index, query) pairs, the predictions
    gathered by query index, and ``serving.serve`` given the original
    query."""
    supplemented = [(i, serving.supplement(q)) for i, (q, _) in enumerate(qa_pairs)]
    per_algo = [dict(algo.batch_predict(model, supplemented))
                for algo, model in zip(algorithms, models)]
    return [(q, serving.serve(q, [preds[i] for preds in per_algo if i in preds]), a)
            for i, (q, a) in enumerate(qa_pairs)]


@dataclasses.dataclass
class TrainResult:
    """The trained models, one per algorithm, beside the algorithms that
    trained them and what each algorithm's ``make_persistent_model``
    returned (all ``None`` when the workflow does not save)."""

    algorithms: list[Algorithm]
    models: list[Any]
    persisted: list[Any]


class Engine:
    """Component maps are name -> class; EngineParams names select the
    class per slot."""

    def __init__(
        self,
        data_source_class_map: Mapping[str, type] | type,
        preparator_class_map: Mapping[str, type] | type,
        algorithm_class_map: Mapping[str, type] | type,
        serving_class_map: Mapping[str, type] | type,
    ):
        self.data_source_class_map = self._as_map(data_source_class_map)
        self.preparator_class_map = self._as_map(preparator_class_map)
        self.algorithm_class_map = self._as_map(algorithm_class_map)
        self.serving_class_map = self._as_map(serving_class_map)

    @staticmethod
    def _as_map(m: Mapping[str, type] | type) -> dict[str, type]:
        """Single-class sugar: Engine(MyDS, MyPrep, MyAlgo, MyServing)."""
        if isinstance(m, Mapping):
            return dict(m)
        return {"": m}

    def _component(self, class_map: Mapping[str, type], slot: str, name_params: tuple[str, Any]):
        name, params = name_params
        if name not in class_map:
            raise ValueError(
                f"{slot} has no component named {name!r} "
                f"(available: {sorted(class_map)})"
            )
        return Doer.create(class_map[name], params)

    def make_components(self, engine_params: EngineParams) -> tuple[
        DataSource, Preparator, list[Algorithm], Serving
    ]:
        data_source = self._component(
            self.data_source_class_map, "datasource", engine_params.data_source_params
        )
        preparator = self._component(
            self.preparator_class_map, "preparator", engine_params.preparator_params
        )
        algo_list = list(engine_params.algorithm_params_list) or [("", None)]
        algorithms = [
            self._component(self.algorithm_class_map, "algorithms", ap)
            for ap in algo_list
        ]
        serving = self._component(
            self.serving_class_map, "serving", engine_params.serving_params
        )
        return data_source, preparator, algorithms, serving

    def train(self, ctx: Any, engine_params: EngineParams,
              stage_seconds: dict[str, float] | None = None,
              algorithms: Sequence[Algorithm] | None = None) -> TrainResult:
        """read → sanity → prepare → sanity → train each algorithm →
        sanity → ``make_persistent_model`` of each (when the workflow
        saves), honouring the workflow's stop-after-read/prepare flags.
        ``algorithms`` (default: fresh ones from the params) are the
        instances that train. ``stage_seconds``, when given, receives
        the read, prepare, train and persist seconds (the training stage
        ends when every model is back, which for the sessionrec template
        means on the host)."""
        params = ctx.workflow_params
        data_source, preparator, made, _ = self.make_components(engine_params)
        algorithms = made if algorithms is None else list(algorithms)
        with _stage(stage_seconds, "read"):
            td = data_source.read_training(ctx)
        _sanity_check(td, "training data", not params.skip_sanity_check)
        if params.stop_after_read:
            raise StopAfterReadInterruption("stopping after read per workflow params")

        with _stage(stage_seconds, "prepare"):
            pd = preparator.prepare(ctx, td)
        _sanity_check(pd, "prepared data", not params.skip_sanity_check)
        if params.stop_after_prepare:
            raise StopAfterPrepareInterruption("stopping after prepare per workflow params")

        models: list[Any] = []
        for i, algo in enumerate(algorithms):
            logger.info("training algorithm %d: %s", i, type(algo).__name__)
            with _stage(stage_seconds, "train"):
                model = algo.train(ctx, pd)
            _sanity_check(model, f"model[{i}]", not params.skip_sanity_check)
            models.append(model)
        with _stage(stage_seconds, "persist"):
            persisted = [
                algo.make_persistent_model(ctx.with_workflow_params(algorithm_slot=i), model)
                if params.save_model else None
                for i, (algo, model) in enumerate(zip(algorithms, models))]
        return TrainResult(algorithms=list(algorithms), models=models, persisted=persisted)

    def prepare_deploy(self, ctx: Any, engine_params: EngineParams, persisted: Sequence[Any],
                       algorithms: Sequence[Algorithm] | None = None) -> list[Any]:
        """The deployable models from what training persisted: a
        manifest loads through its algorithm's ``load_model`` (on
        ``ctx.device``), a model serves as it is (``load_models`` has put
        its tensors on the device), and ``None`` means retrain at deploy
        (without saving). ``algorithms`` must be the
        instances that will serve, since load and train hooks may keep
        serve-time state on them."""
        if algorithms is None:
            _, _, algorithms, _ = self.make_components(engine_params)
        retrained = None
        if any(p is None for p in persisted):
            logger.info("some models were not persisted; retraining for deploy")
            retrained = self.train(ctx.with_workflow_params(save_model=False), engine_params,
                                   algorithms=algorithms)
        models = []
        for i, (algo, blob) in enumerate(zip(algorithms, persisted)):
            if blob is None:
                models.append(retrained.models[i])
            elif isinstance(blob, PersistentModelManifest):
                models.append(algo.load_model(ctx, blob))
            else:
                models.append(blob)
        return models

    def eval(self, ctx: Any, engine_params: EngineParams) -> list[tuple[Any, list[tuple]]]:
        """Per fold of ``read_eval``: sanity check, prepare, train every
        algorithm, then serve the fold's queries (:func:`serve_fold`).
        Returns per fold ``(evaluation info, [(query, served, actual)])``."""
        data_source, preparator, algorithms, serving = self.make_components(engine_params)
        results = []
        for fold, (td, ei, qa_pairs) in enumerate(data_source.read_eval(ctx)):
            logger.info("evaluating fold %d (%d queries)", fold, len(qa_pairs))
            _sanity_check(td, f"fold[{fold}] training data",
                          not ctx.workflow_params.skip_sanity_check)
            pd = preparator.prepare(ctx, td)
            models = [algo.train(ctx, pd) for algo in algorithms]
            results.append((ei, serve_fold(algorithms, models, serving, qa_pairs)))
        return results

    def batch_eval(self, ctx: Any, engine_params_list: Sequence[EngineParams]
                   ) -> list[tuple[EngineParams, list[tuple[Any, list[tuple]]]]]:
        """:meth:`eval` of every grid point, in order."""
        return [(ep, self.eval(ctx, ep)) for ep in engine_params_list]

    def params_from_variant_json(self, variant: Mapping[str, Any]) -> EngineParams:
        """Bind an engine.json variant: each of "datasource",
        "preparator" and "serving" is ``{"name": ..., "params": {...}}``
        (an omitted slot takes the one component of its map with default
        params), "algorithms" a list of them (omitted: the one algorithm
        with default params)."""

        def only_name(class_map: Mapping[str, type], key: str) -> str:
            if "" in class_map:
                return ""
            if len(class_map) == 1:
                return next(iter(class_map))
            raise ValueError(f"engine.json omits {key!r} but the engine has several "
                             f"{key} components {sorted(class_map)}; name one")

        def bind(spec: Mapping[str, Any] | None, class_map: Mapping[str, type],
                 key: str) -> tuple[str, Any]:
            name = only_name(class_map, key) if spec is None else spec.get("name", "")
            if name not in class_map:
                raise ValueError(f"engine.json {key} names unknown component {name!r} "
                                 f"(available: {sorted(class_map)})")
            return (name, params_from_json(class_map[name].params_class,
                                           None if spec is None else spec.get("params")))

        algorithms = [bind(spec, self.algorithm_class_map, "algorithms")
                      for spec in variant.get("algorithms", [])]
        return EngineParams(
            data_source_params=bind(variant.get("datasource"), self.data_source_class_map,
                                    "datasource"),
            preparator_params=bind(variant.get("preparator"), self.preparator_class_map,
                                   "preparator"),
            algorithm_params_list=tuple(algorithms) or (
                bind(None, self.algorithm_class_map, "algorithms"),),
            serving_params=bind(variant.get("serving"), self.serving_class_map, "serving"),
        )

    def params_from_instance_json(
        self,
        data_source_params: str,
        preparator_params: str,
        algorithms_params: str,
        serving_params: str,
    ) -> EngineParams:
        """Rebuild typed EngineParams from the JSON blobs stored on an
        engine instance: each slot is ``{"name": ..., "params": {...}}``
        and the algorithms a list of them."""

        def slot(raw: str, class_map: Mapping[str, type]) -> tuple[str, Any]:
            spec = json.loads(raw) if raw else {"name": "", "params": {}}
            name = spec.get("name", "")
            cls = class_map.get(name)
            if cls is None:
                raise ValueError(f"stored params name {name!r} not in {sorted(class_map)}")
            return (name, params_from_json(cls.params_class, spec.get("params")))

        algo_specs = json.loads(algorithms_params) if algorithms_params else []
        algorithms = []
        for spec in algo_specs:
            name = spec.get("name", "")
            cls = self.algorithm_class_map.get(name)
            if cls is None:
                raise ValueError(
                    f"stored algorithm name {name!r} not in {sorted(self.algorithm_class_map)}"
                )
            algorithms.append((name, params_from_json(cls.params_class, spec.get("params"))))
        return EngineParams(
            data_source_params=slot(data_source_params, self.data_source_class_map),
            preparator_params=slot(preparator_params, self.preparator_class_map),
            algorithm_params_list=tuple(algorithms),
            serving_params=slot(serving_params, self.serving_class_map),
        )


class EngineFactory:
    """Subclass and implement ``apply``; or pass any zero-arg callable
    returning an Engine."""

    def apply(self) -> Engine:
        raise NotImplementedError


def resolve_engine_factory(spec: str) -> Callable[[], Engine]:
    """Resolve an engineFactory string "pkg.module.obj" /
    "pkg.module:obj" to a zero-arg callable returning an Engine."""
    obj = resolve_attr(spec)
    if isinstance(obj, Engine):
        return lambda: obj
    if isinstance(obj, type) and issubclass(obj, EngineFactory):
        return lambda: obj().apply()
    if callable(obj):
        return obj
    raise TypeError(f"engineFactory {spec!r} is not callable or an Engine")
