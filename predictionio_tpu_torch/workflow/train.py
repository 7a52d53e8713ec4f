"""The training workflow driver (port of the JAX package's
``workflow/train.py``): resolve the engine factory, bind the engine.json
variant, record an INIT ``EngineInstance``, run ``Engine.train`` on the
context's device, persist the models (``workflow/persistence.py``) and
mark the instance COMPLETED. A stop-after-read/prepare run ends
INTERRUPTED; a run that raises ends FAILED and re-raises.
``workflow/deploy.load_deployed_engine`` finds the instance by id or as
the latest COMPLETED one.

Every run is traced: ``Engine.train`` records the read, prepare, train
and persist stages as spans on a ``Trace`` bound here, the final
persist (``save_models``) is one more persist span, and
``TrainOutcome.stage_seconds`` is read from those spans. A
``profiler`` (``obs/device.TrainProfiler``, ``pio train --profile``)
binds to that trace and its report lands on ``TrainOutcome.report``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import traceback
from datetime import datetime, timezone
from typing import Any, Mapping

from predictionio_tpu_torch.controller.engine import (
    Engine,
    StopAfterPrepareInterruption,
    StopAfterReadInterruption,
    resolve_engine_factory,
)
from predictionio_tpu_torch.controller.params import EngineParams, params_to_json
from predictionio_tpu_torch.obs.trace import Trace, span, use_trace
from predictionio_tpu_torch.storage.base import EngineInstance
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.workflow.context import EngineContext, WorkflowParams
from predictionio_tpu_torch.workflow.engine_json import mesh_conf_from_variant
from predictionio_tpu_torch.workflow.persistence import save_models

logger = logging.getLogger(__name__)


def format_stage_times(stage_seconds: Mapping[str, float]) -> str:
    """One-line stage breakdown, e.g.
    ``read 0.52s | prepare 0.11s | train 8.43s | persist 0.04s``."""
    return " | ".join(f"{name} {secs:.2f}s" for name, secs in stage_seconds.items())


def _now() -> datetime:
    return datetime.now(timezone.utc)


def _params_json(name_params: tuple[str, Any]) -> str:
    name, params = name_params
    return json.dumps({"name": name, "params": params_to_json(params)})


def _algo_params_json(algorithm_params_list) -> str:
    return json.dumps(
        [{"name": n, "params": params_to_json(p)} for n, p in algorithm_params_list])


@dataclasses.dataclass
class TrainOutcome:
    instance_id: str
    status: str                  # COMPLETED | INTERRUPTED
    models: list[Any]
    #: read / prepare / train / persist seconds, in that order, from the
    #: training trace's spans
    stage_seconds: dict[str, float] = dataclasses.field(default_factory=dict)
    #: the TRAIN_REPORT document when the run was profiled (``pio train
    #: --profile``; obs/device.TrainProfiler)
    report: dict[str, Any] | None = None


def run_train(
    engine: Engine | None = None,
    engine_factory: str = "",
    variant: Mapping[str, Any] | None = None,
    engine_params: EngineParams | None = None,
    workflow_params: WorkflowParams = WorkflowParams(),
    storage: Storage | None = None,
    ctx: EngineContext | None = None,
    profiler: Any | None = None,
) -> TrainOutcome:
    """Train one engine variant and persist the results.

    Pass a constructed ``engine`` or an ``engine_factory`` spec (default:
    the variant's "engineFactory"). ``variant`` is the parsed
    engine.json; ``engine_params`` overrides its binding. The instance
    and the models go to ``storage`` (default: the context's, else
    ``Storage()`` from the environment); ``ctx`` (default: one on the
    card with ``workflow_params`` over that storage) carries the device,
    the devices of its mesh and the workflow params; the variant's
    ``meshConf`` becomes the run's ``mesh_conf`` unless the context has
    one, and the instance records it. ``profiler`` (an
    ``obs/device.TrainProfiler``) is always finished, so a failed run
    leaves no profiler running."""
    storage = storage or (ctx.storage if ctx is not None else Storage())
    variant = dict(variant or {})
    if engine is None:
        engine_factory = engine_factory or variant.get("engineFactory", "")
        if not engine_factory:
            raise ValueError("run_train needs an engine or an engineFactory spec")
        engine = resolve_engine_factory(engine_factory)()
    if engine_params is None:
        engine_params = engine.params_from_variant_json(variant)
    ctx = ctx or EngineContext(workflow_params=workflow_params, storage=storage)
    if not ctx.workflow_params.mesh_conf:
        mesh_conf = mesh_conf_from_variant(variant)
        if mesh_conf:
            ctx = ctx.with_workflow_params(mesh_conf=mesh_conf)
    wp = ctx.workflow_params

    instances = storage.get_meta_data_engine_instances()
    instance_id = instances.insert(EngineInstance(
        id="",
        status="INIT",
        start_time=_now(),
        completion_time=_now(),
        engine_id=variant.get("id", "default"),
        engine_version=variant.get("version", "1"),
        engine_variant=variant.get("variantId", variant.get("id", "default")),
        engine_factory=engine_factory or f"{type(engine).__module__}.{type(engine).__qualname__}",
        batch=wp.batch,
        mesh_conf=dict(wp.mesh_conf),
        data_source_params=_params_json(engine_params.data_source_params),
        preparator_params=_params_json(engine_params.preparator_params),
        algorithms_params=_algo_params_json(engine_params.algorithm_params_list),
        serving_params=_params_json(engine_params.serving_params),
    ))
    logger.info("engine instance %s: INIT", instance_id)
    ctx = ctx.with_workflow_params(engine_instance_id=instance_id)

    def finish(status: str) -> None:
        instances.update(dataclasses.replace(instances.get(instance_id), status=status,
                                             completion_time=_now()))

    trace = Trace("train", request_id=instance_id)
    if profiler is not None:
        profiler.begin(trace, device=ctx.device)
    try:
        try:
            with use_trace(trace):
                result = engine.train(ctx, engine_params)
        except (StopAfterReadInterruption, StopAfterPrepareInterruption) as stop:
            finish("INTERRUPTED")
            logger.info("engine instance %s: INTERRUPTED (%s)", instance_id, stop)
            report = (profiler.finish(trace, instance_id, "INTERRUPTED")
                      if profiler is not None else None)
            return TrainOutcome(instance_id, "INTERRUPTED", [], trace.stage_seconds(),
                                report=report)
        with use_trace(trace), span("persist"):
            save_models(storage, instance_id, result.persisted)
        finish("COMPLETED")
        stage_seconds = trace.stage_seconds()
        logger.info("engine instance %s: COMPLETED (%s)", instance_id,
                    format_stage_times(stage_seconds))
        report = (profiler.finish(trace, instance_id, "COMPLETED")
                  if profiler is not None else None)
        return TrainOutcome(instance_id, "COMPLETED", result.models, stage_seconds,
                            report=report)
    except Exception:
        # a failed run never reads as COMPLETED
        finish("FAILED")
        logger.error("engine instance %s: FAILED\n%s", instance_id, traceback.format_exc())
        raise
    finally:
        if profiler is not None:
            # idempotent: stops the profiler on the failure path (the
            # returns above finished it with their own status)
            profiler.finish(trace, instance_id, "FAILED")
