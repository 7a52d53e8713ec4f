"""Workflow layer: the train, evaluation and deploy drivers, engine.json
parsing, model persistence."""

from predictionio_tpu_torch.workflow.context import EngineContext, WorkflowParams

__all__ = ["EngineContext", "WorkflowParams"]
