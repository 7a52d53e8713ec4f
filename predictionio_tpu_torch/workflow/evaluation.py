"""The evaluation workflow driver (port of the JAX package's
``workflow/evaluation.py``): resolve the Evaluation and the
EngineParamsGenerator, record an INIT ``EvaluationInstance``, run
``engine.batch_eval`` over the grid on the context's device, score it
with the evaluator and persist the renders (one-liner, HTML, JSON) on the
instance as EVALCOMPLETED. A raising ``batch_eval`` or evaluator leaves
the instance FAILED, with the error, and re-raises; a result marked
``no_save`` leaves it at INIT.

Not ported: the parallel grid (``parallel > 1`` or ``PIO_EVAL_PARALLEL``
raises, naming ROADMAP.md queue 1 item 17; there is no quiet fall back
to the sequential path), and the JAX package's counter of sequentially
evaluated grid points, an observability metric that comes with the
support layers of ROADMAP.md queue 1 item 12.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from datetime import datetime, timezone
from typing import Any

from predictionio_tpu_torch.controller.engine import _resolve_attr
from predictionio_tpu_torch.controller.evaluation import (
    BaseEvaluatorResult,
    EngineParamsGenerator,
    Evaluation,
)
from predictionio_tpu_torch.storage.base import EvaluationInstance, EvaluationInstances
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.workflow.context import EngineContext, WorkflowParams

logger = logging.getLogger(__name__)

#: the ROADMAP.md item that ports the parallel grid (the JAX package's
#: ``experiment/grid.py``)
PARALLEL_ITEM = "ROADMAP.md queue 1 item 17"


def _now() -> datetime:
    return datetime.now(timezone.utc)


def resolve_object(spec: str) -> Any:
    """"pkg.module.Obj" or "pkg.module:Obj" → the object; a class is
    instantiated with no arguments."""
    obj = _resolve_attr(spec)
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
    above 1 raises before anything is recorded."""
    if resolve_parallel(parallel) > 1:
        raise NotImplementedError(
            "the parallel evaluation grid is not ported yet (the JAX package's "
            f"experiment/grid.py): {PARALLEL_ITEM}; run with parallel=1")
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
    ))
    logger.info("evaluation instance %s: INIT", instance_id)

    try:
        engine, evaluator = evaluation.engine_evaluator
        engine_eval_data_set = engine.batch_eval(ctx, engine_params_generator.engine_params_list)
        result = evaluator.evaluate(ctx, evaluation, engine_eval_data_set)
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
