"""FastEvalEngine: grid evaluation that shares pipeline prefixes (port of
the JAX package's ``controller/fast_eval.py``).

Neighbouring points of a grid usually differ in one stage, so re-running
read → prepare → train → predict for every point repeats the shared
prefix. :class:`FastEvalEngineWorkflow` memoizes, for one ``batch_eval``:

- the data source's folds, by its params;
- the prepared data of each fold, by the data source's and preparator's;
- the trained models of each fold, by those and the algorithms' list;
- the served (Q, P, A) triples, by those and the serving's.

Keys are the canonical JSON of the slot params, so equal params hit.

As in the JAX package, prediction runs at the serving stage, after the
real ``supplement``: a grid whose points differ only in serving params
predicts again for each, and every point keeps ``Engine.eval``'s exact
semantics.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Sequence

from predictionio_tpu_torch.controller.engine import Engine, _sanity_check, serve_fold
from predictionio_tpu_torch.controller.params import EngineParams, params_to_json

logger = logging.getLogger(__name__)


def _slot_key(name_params: tuple[str, Any]) -> str:
    name, params = name_params
    return json.dumps({"name": name, "params": params_to_json(params)}, sort_keys=True)


def _algos_key(algorithm_params_list: Sequence[tuple[str, Any]]) -> str:
    return json.dumps(
        [{"name": n, "params": params_to_json(p)} for n, p in algorithm_params_list],
        sort_keys=True,
    )


class FastEvalEngineWorkflow:
    """The memo tables of one ``batch_eval`` run."""

    def __init__(self, engine: Engine, ctx: Any):
        self.engine = engine
        self.ctx = ctx
        self.data_source_cache: dict[str, list] = {}
        self.preparator_cache: dict[tuple[str, str], list] = {}
        self.algorithms_cache: dict[tuple[str, str, str], list] = {}
        self.serving_cache: dict[tuple[str, str, str, str], list] = {}

    def get_data_source_result(self, ep: EngineParams) -> list:
        """The folds of ``read_eval``, each fold's training data sanity-checked."""
        key = _slot_key(ep.data_source_params)
        if key not in self.data_source_cache:
            data_source = self.engine._component(
                self.engine.data_source_class_map, "datasource", ep.data_source_params)
            splits = list(data_source.read_eval(self.ctx))
            for fold, (td, _, _) in enumerate(splits):
                _sanity_check(td, f"fold[{fold}] training data",
                              not self.ctx.workflow_params.skip_sanity_check)
            self.data_source_cache[key] = splits
        return self.data_source_cache[key]

    def get_preparator_result(self, ep: EngineParams) -> list:
        """The prepared data of each fold."""
        key = (_slot_key(ep.data_source_params), _slot_key(ep.preparator_params))
        if key not in self.preparator_cache:
            preparator = self.engine._component(
                self.engine.preparator_class_map, "preparator", ep.preparator_params)
            self.preparator_cache[key] = [
                preparator.prepare(self.ctx, td) for td, _, _ in self.get_data_source_result(ep)]
        return self.preparator_cache[key]

    def get_algorithms_result(self, ep: EngineParams) -> list:
        """Per fold, (the algorithms, the model each trained)."""
        key = (_slot_key(ep.data_source_params), _slot_key(ep.preparator_params),
               _algos_key(ep.algorithm_params_list))
        if key not in self.algorithms_cache:
            algorithms = [
                self.engine._component(self.engine.algorithm_class_map, "algorithms", ap)
                for ap in list(ep.algorithm_params_list) or [("", None)]]
            self.algorithms_cache[key] = [
                (algorithms, [algo.train(self.ctx, pd) for algo in algorithms])
                for pd in self.get_preparator_result(ep)]
        return self.algorithms_cache[key]

    def get_serving_result(self, ep: EngineParams) -> list:
        """Per fold, (evaluation info, [(query, served, actual)])."""
        key = (_slot_key(ep.data_source_params), _slot_key(ep.preparator_params),
               _algos_key(ep.algorithm_params_list), _slot_key(ep.serving_params))
        if key not in self.serving_cache:
            serving = self.engine._component(
                self.engine.serving_class_map, "serving", ep.serving_params)
            self.serving_cache[key] = [
                (ei, serve_fold(algorithms, models, serving, qa_pairs))
                for (_, ei, qa_pairs), (algorithms, models) in zip(
                    self.get_data_source_result(ep), self.get_algorithms_result(ep))]
        return self.serving_cache[key]


class FastEvalEngine(Engine):
    """An Engine whose ``batch_eval`` shares pipeline prefixes across the
    grid."""

    def batch_eval(self, ctx: Any, engine_params_list: Sequence[EngineParams]
                   ) -> list[tuple[EngineParams, list]]:
        workflow = FastEvalEngineWorkflow(self, ctx)
        return [(ep, workflow.get_serving_result(ep)) for ep in engine_params_list]
