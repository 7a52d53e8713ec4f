"""The training workflow driver (port of the JAX package's
``workflow/train.py``): resolve the engine factory, bind the engine.json
variant, run ``Engine.train`` and save each algorithm's model to a
directory that ``workflow/deploy.load_deployed_engine`` reads.

The engine-instance record and the model repository that ``pio train``
keeps in storage come with ROADMAP.md queue 1 item 3; until then the
model directory is the handle between training and deployment.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Mapping

from predictionio_tpu_torch.controller.engine import (
    StopAfterPrepareInterruption,
    StopAfterReadInterruption,
    resolve_engine_factory,
)
from predictionio_tpu_torch.workflow.context import EngineContext

logger = logging.getLogger(__name__)


def format_stage_times(stage_seconds: Mapping[str, float]) -> str:
    """One-line stage breakdown, e.g.
    ``read 0.52s | prepare 0.11s | train 8.43s | persist 0.04s``."""
    return " | ".join(f"{name} {secs:.2f}s" for name, secs in stage_seconds.items())


@dataclasses.dataclass
class TrainOutcome:
    status: str                  # COMPLETED | INTERRUPTED
    models: list[Any]
    #: read / prepare / train / persist seconds, in that order
    stage_seconds: dict[str, float]


def run_train(variant: Mapping[str, Any], ctx: EngineContext,
              model_dir: str | None = None) -> TrainOutcome:
    """Train one engine variant and save its models.

    ``variant`` is the parsed engine.json: its "engineFactory" names the
    engine and its slots bind the params. ``ctx`` carries the workflow
    params, the storage and the device. Each algorithm's model is saved
    to ``model_dir``, or to ``model_dir/<i>`` when there are several,
    unless the workflow params turn saving off."""
    engine_factory = variant.get("engineFactory", "")
    if not engine_factory:
        raise ValueError("run_train needs an engine.json variant with an engineFactory")
    engine = resolve_engine_factory(engine_factory)()
    engine_params = engine.params_from_variant_json(variant)
    save = ctx.workflow_params.save_model
    if save and model_dir is None:
        raise ValueError("run_train needs a model_dir to save to (the model repository "
                         "comes with ROADMAP.md queue 1 item 3)")

    stage_seconds: dict[str, float] = {}
    try:
        result = engine.train(ctx, engine_params, stage_seconds)
    except (StopAfterReadInterruption, StopAfterPrepareInterruption) as stop:
        logger.info("training interrupted (%s)", stop)
        return TrainOutcome("INTERRUPTED", [], stage_seconds)

    t0 = time.perf_counter()
    if save:
        n = len(result.algorithms)
        dirs = [model_dir] if n == 1 else [os.path.join(model_dir, str(i)) for i in range(n)]
        for algo, model, d in zip(result.algorithms, result.models, dirs):
            algo.save_model(model, d)
    stage_seconds["persist"] = time.perf_counter() - t0
    logger.info("training COMPLETED (%s)", format_stage_times(stage_seconds))
    return TrainOutcome("COMPLETED", result.models, stage_seconds)
