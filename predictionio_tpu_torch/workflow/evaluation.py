"""The evaluation workflow driver (port of the JAX package's
``workflow/evaluation.py``): resolve the Evaluation and the
EngineParamsGenerator, record an INIT ``EvaluationInstance``, run
``engine.batch_eval`` over the grid on the context's device, score it
with the evaluator and persist the renders (one-liner, HTML, JSON) on the
instance as EVALCOMPLETED. A raising ``batch_eval`` or evaluator leaves
the instance FAILED, with the error, and re-raises; a result marked
``no_save`` leaves it at INIT.

``parallel > 1`` (``pio eval --parallel N`` / ``PIO_EVAL_PARALLEL``)
fans the grid points of a ``MetricEvaluator`` over forked eval worker
processes (``experiment/grid.py``) with per-point fault isolation,
streaming each point into the instance row as it lands: the row reads
``EVALUATING`` with the partial grid in ``evaluator_results_json``
mid-run. Another evaluator takes the sequential path with a warning, as
in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from datetime import datetime, timezone
from typing import Any

from predictionio_tpu_torch.controller.evaluation import (
    BaseEvaluatorResult,
    EngineParamsGenerator,
    Evaluation,
    MetricEvaluator,
)
from predictionio_tpu_torch.experiment.grid import (
    count_sequential_points,
    partial_grid_doc,
    result_from_points,
    run_parallel_grid,
)
from predictionio_tpu_torch.storage.base import EvaluationInstance, EvaluationInstances
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.reflection import resolve_attr
from predictionio_tpu_torch.workflow.context import EngineContext, WorkflowParams

logger = logging.getLogger(__name__)


def _now() -> datetime:
    return datetime.now(timezone.utc)


def resolve_object(spec: str) -> Any:
    """"pkg.module.Obj" or "pkg.module:Obj" → the object; a class is
    instantiated with no arguments."""
    obj = resolve_attr(spec)
    if isinstance(obj, type):
        obj = obj()
    return obj


def resolve_parallel(parallel: int | None) -> int:
    """The argument, else ``PIO_EVAL_PARALLEL``, else 1; never below 1,
    and an unreadable variable counts as 1."""
    if parallel is not None:
        return max(1, int(parallel))
    try:
        return max(1, int(os.environ.get("PIO_EVAL_PARALLEL", "1")))
    except ValueError:
        return 1


@dataclasses.dataclass
class EvalOutcome:
    instance_id: str
    status: str                  # EVALCOMPLETED | NOSAVE
    result: BaseEvaluatorResult


def run_evaluation(
    evaluation: Evaluation | str,
    engine_params_generator: EngineParamsGenerator | str,
    workflow_params: WorkflowParams = WorkflowParams(),
    storage: Storage | None = None,
    ctx: EngineContext | None = None,
    parallel: int | None = None,
) -> EvalOutcome:
    """Evaluate an engine over a params grid and persist the result.

    ``evaluation`` and ``engine_params_generator`` are instances or
    "pkg.module.Obj" specs. The instance is recorded in ``storage``
    (default: the context's, else ``Storage()`` from the environment);
    ``ctx`` (default: one on the card with ``workflow_params`` over that
    storage) carries the device the grid trains and predicts on and the
    workflow params, whose ``batch`` the instance records. ``parallel``
    above 1 fans the grid points over that many forked eval worker
    processes (``None`` reads ``PIO_EVAL_PARALLEL``); on the card, this
    process must not have initialized CUDA (``experiment/grid.py``)."""
    if isinstance(evaluation, str):
        evaluation = resolve_object(evaluation)
    if isinstance(engine_params_generator, str):
        engine_params_generator = resolve_object(engine_params_generator)
    if not isinstance(evaluation, Evaluation):
        raise TypeError(f"{evaluation!r} is not an Evaluation")

    storage = storage or (ctx.storage if ctx is not None else Storage())
    ctx = ctx or EngineContext(workflow_params=workflow_params, storage=storage)
    instances = storage.get_meta_data_evaluation_instances()
    instance_id = instances.insert(EvaluationInstance(
        id="",
        status="INIT",
        start_time=_now(),
        completion_time=_now(),
        evaluation_class=f"{type(evaluation).__module__}.{type(evaluation).__qualname__}",
        engine_params_generator_class=(
            f"{type(engine_params_generator).__module__}."
            f"{type(engine_params_generator).__qualname__}"),
        batch=ctx.workflow_params.batch,
        mesh_conf=dict(ctx.workflow_params.mesh_conf),
    ))
    logger.info("evaluation instance %s: INIT", instance_id)

    parallel = resolve_parallel(parallel)
    try:
        engine, evaluator = evaluation.engine_evaluator
        params_list = engine_params_generator.engine_params_list
        if parallel > 1 and isinstance(evaluator, MetricEvaluator):
            result = _run_parallel(evaluation, evaluator, params_list, ctx, parallel,
                                   instances, instance_id)
        else:
            if parallel > 1:
                logger.warning(
                    "--parallel %d ignored: %s is not a MetricEvaluator (children ship "
                    "plain scores, not EvalDataSets): falling back to the sequential path",
                    parallel, type(evaluator).__name__)
            engine_eval_data_set = engine.batch_eval(ctx, params_list)
            result = evaluator.evaluate(ctx, evaluation, engine_eval_data_set)
            count_sequential_points(len(params_list))
    except Exception as exc:
        _persist_failed(instances, instance_id, exc)
        raise

    if result.no_save:
        logger.info("evaluation instance %s: results not saved (noSave)", instance_id)
        return EvalOutcome(instance_id, "NOSAVE", result)
    instances.update(dataclasses.replace(
        instances.get(instance_id),
        status="EVALCOMPLETED",
        completion_time=_now(),
        evaluator_results=result.to_one_liner(),
        evaluator_results_html=result.to_html(),
        evaluator_results_json=result.to_json(),
    ))
    logger.info("evaluation instance %s: EVALCOMPLETED: %s", instance_id, result.to_one_liner())
    return EvalOutcome(instance_id, "EVALCOMPLETED", result)


def _run_parallel(evaluation, evaluator, params_list, ctx, parallel, instances,
                  instance_id):
    """The parallel grid: stream each finished point into the instance
    row (status EVALUATING: the partial grid is visible mid-run), then
    reassemble the full MetricEvaluatorResult, whose JSON gains the
    per-point ledger."""
    total = len(params_list)
    seen = []

    def _stream(point, done, _total):
        seen.append(point)
        instances.update(dataclasses.replace(
            instances.get(instance_id),
            status="EVALUATING",
            evaluator_results_json=partial_grid_doc(seen, total)))

    logger.info("evaluation instance %s: EVALUATING (%d grid points over %d eval workers)",
                instance_id, total, parallel)
    points = run_parallel_grid(evaluation, evaluator, params_list, ctx, parallel,
                               on_point=_stream)
    result = result_from_points(evaluator, params_list, points, evaluation=evaluation)
    # the final JSON keeps the MetricEvaluatorResult contract
    # (metricHeader/bestIdx/engineParamsScores) and adds the per-point
    # status ledger
    doc = json.loads(result.to_json())
    doc["points"] = [p.to_doc() for p in points]
    result.to_json = lambda: json.dumps(doc, indent=2)  # type: ignore[method-assign]
    return result


def _persist_failed(instances: EvaluationInstances, instance_id: str, exc: Exception) -> None:
    """Mark the instance FAILED with the error; a metadata store that
    fails too is logged, so the caller still sees the original error."""
    try:
        instances.update(dataclasses.replace(
            instances.get(instance_id),
            status="FAILED",
            completion_time=_now(),
            evaluator_results=f"{type(exc).__name__}: {exc}",
        ))
        logger.error("evaluation instance %s: FAILED: %s", instance_id, exc)
    except Exception:
        logger.exception("could not persist FAILED status for evaluation instance %s",
                         instance_id)
