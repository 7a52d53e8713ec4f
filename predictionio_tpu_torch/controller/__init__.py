from predictionio_tpu_torch.controller.algorithm import HostModelAlgorithm
from predictionio_tpu_torch.controller.base import (
    Algorithm,
    BaseComponent,
    DataSource,
    Doer,
    FirstServing,
    IdentityPreparator,
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
from predictionio_tpu_torch.controller.params import (
    EmptyParams,
    EngineParams,
    Params,
    params_from_json,
)

__all__ = [
    "Algorithm", "BaseComponent", "DataSource", "Doer", "EmptyParams", "Engine",
    "EngineFactory", "EngineParams", "FirstServing", "HostModelAlgorithm",
    "IdentityPreparator", "Params", "Preparator", "SanityCheck", "Serving",
    "StopAfterPrepareInterruption", "StopAfterReadInterruption", "TrainResult",
    "params_from_json", "resolve_engine_factory",
]
