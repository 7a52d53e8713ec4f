from predictionio_tpu_torch.controller.algorithm import HostModelAlgorithm
from predictionio_tpu_torch.controller.base import (
    Algorithm,
    BaseComponent,
    Doer,
    FirstServing,
    IdentityPreparator,
    Preparator,
    Serving,
)
from predictionio_tpu_torch.controller.engine import (
    Engine,
    EngineFactory,
    resolve_engine_factory,
)
from predictionio_tpu_torch.controller.params import (
    EmptyParams,
    EngineParams,
    Params,
    params_from_json,
)

__all__ = [
    "Algorithm", "BaseComponent", "Doer", "EmptyParams", "Engine",
    "EngineFactory", "EngineParams", "FirstServing", "HostModelAlgorithm",
    "IdentityPreparator", "Params", "Preparator", "Serving",
    "params_from_json", "resolve_engine_factory",
]
