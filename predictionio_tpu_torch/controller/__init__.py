from predictionio_tpu_torch.controller.algorithm import (
    HostModelAlgorithm,
    LocalAlgorithm,
    ShardedAlgorithm,
)
from predictionio_tpu_torch.controller.base import (
    Algorithm,
    AverageServing,
    BaseComponent,
    DataSource,
    Doer,
    Evaluator,
    FirstServing,
    IdentityPreparator,
    PersistentModelManifest,
    Preparator,
    SanityCheck,
    Serving,
)
from predictionio_tpu_torch.controller.engine import (
    Engine,
    EngineFactory,
    StopAfterPrepareInterruption,
    StopAfterReadInterruption,
    TrainResult,
    resolve_engine_factory,
)
from predictionio_tpu_torch.controller.evaluation import (
    BaseEvaluator,
    BaseEvaluatorResult,
    EngineParamsGenerator,
    Evaluation,
    MetricEvaluator,
    MetricEvaluatorResult,
    MetricScores,
)
from predictionio_tpu_torch.controller.fast_eval import FastEvalEngine
from predictionio_tpu_torch.controller.metrics import (
    AverageMetric,
    Metric,
    OptionAverageMetric,
    OptionStdevMetric,
    QPAMetric,
    StdevMetric,
    SumMetric,
    ZeroMetric,
)
from predictionio_tpu_torch.controller.params import (
    EmptyParams,
    EngineParams,
    Params,
    params_from_json,
    params_to_json,
)

__all__ = [
    "Algorithm", "AverageServing", "BaseComponent", "DataSource", "Doer", "EmptyParams",
    "Engine", "Evaluator",
    "EngineFactory", "EngineParams", "FirstServing", "HostModelAlgorithm",
    "IdentityPreparator", "LocalAlgorithm", "Params", "PersistentModelManifest",
    "Preparator", "SanityCheck", "Serving", "ShardedAlgorithm",
    "StopAfterPrepareInterruption", "StopAfterReadInterruption", "TrainResult",
    "params_from_json", "params_to_json", "resolve_engine_factory",
    "Metric", "QPAMetric", "AverageMetric", "OptionAverageMetric",
    "StdevMetric", "OptionStdevMetric", "SumMetric", "ZeroMetric",
    "BaseEvaluator", "BaseEvaluatorResult", "Evaluation",
    "EngineParamsGenerator", "MetricEvaluator", "MetricEvaluatorResult",
    "MetricScores", "FastEvalEngine",
]
