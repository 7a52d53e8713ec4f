"""The serving subset of the DASE Engine (port of the JAX package's
``controller/engine.py``): component construction from typed params,
params from the JSON blobs a stored engine instance carries, and
engine-factory resolution. Training and evaluation come in a later
slice.
"""

from __future__ import annotations

import importlib
import json
from typing import Any, Callable, Mapping

from predictionio_tpu_torch.controller.base import (
    Algorithm,
    BaseComponent,
    Doer,
    Preparator,
    Serving,
)
from predictionio_tpu_torch.controller.params import EngineParams, params_from_json


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
        BaseComponent, Preparator, list[Algorithm], Serving
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


def _resolve_attr(spec: str) -> Any:
    """"pkg.module:attr.path" or "pkg.module.attr" → the object."""
    if ":" in spec:
        module_name, attr = spec.split(":", 1)
    else:
        module_name, _, attr = spec.rpartition(".")
        if not module_name:
            raise ValueError(f"invalid object spec {spec!r}")
    obj: Any = importlib.import_module(module_name)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def resolve_engine_factory(spec: str) -> Callable[[], Engine]:
    """Resolve an engineFactory string "pkg.module.obj" /
    "pkg.module:obj" to a zero-arg callable returning an Engine."""
    obj = _resolve_attr(spec)
    if isinstance(obj, Engine):
        return lambda: obj
    if isinstance(obj, type) and issubclass(obj, EngineFactory):
        return lambda: obj().apply()
    if callable(obj):
        return obj
    raise TypeError(f"engineFactory {spec!r} is not callable or an Engine")
