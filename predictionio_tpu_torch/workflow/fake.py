"""FakeRun: run arbitrary code through the evaluation plumbing (port of
the JAX package's ``workflow/fake.py``, the reference's FakeWorkflow).

A ``ctx -> None`` function is wrapped in a fake engine and evaluator, so
it runs with the full workflow context (storage wired, the device
resolved, an evaluation instance recorded) without a real DASE engine::

    class MyRun(FakeRun):
        def __init__(self):
            super().__init__(lambda ctx: print(ctx.device))

    # pio eval my_module.MyRun predictionio_tpu_torch.workflow.fake.FakeEngineParamsGenerator
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

from predictionio_tpu_torch.controller.engine import Engine
from predictionio_tpu_torch.controller.evaluation import (
    BaseEvaluator,
    BaseEvaluatorResult,
    EngineParamsGenerator,
    Evaluation,
)
from predictionio_tpu_torch.controller.params import EngineParams


class FakeEvalResult(BaseEvaluatorResult):
    """The reference's FakeEvalResult: noSave, so the workflow records
    nothing beyond the run itself."""

    no_save = True

    def to_one_liner(self) -> str:
        return "FakeRun completed"


class _FakeEngine(Engine):
    """Skips the DASE pipeline entirely; ``batch_eval`` calls the function."""

    def __init__(self, fn: Callable[[Any], None]):
        super().__init__({}, {}, {}, {})
        self._fn = fn

    def batch_eval(self, ctx, engine_params_list: Sequence[EngineParams]):
        self._fn(ctx)
        return [(ep, []) for ep in engine_params_list]


class _FakeEvaluator(BaseEvaluator):
    def evaluate(self, ctx, evaluation, engine_eval_data_set):
        return FakeEvalResult()


class FakeRun(Evaluation):
    """The reference's FakeRun."""

    def __init__(self, fn: Callable[[Any], None]):
        super().__init__()
        self.engine_evaluator = (_FakeEngine(fn), _FakeEvaluator())


class FakeEngineParamsGenerator(EngineParamsGenerator):
    """A single empty grid point — all a FakeRun needs."""

    def __init__(self):
        super().__init__([EngineParams()])
