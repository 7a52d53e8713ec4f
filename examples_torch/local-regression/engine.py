"""Local ridge regression — the pure-LocalAlgorithm pattern engine.

Port of the JAX package's ``examples/local-regression``. Role parity:
the reference's ``examples/experimental/scala-local-regression`` (a
local ordinary-least-squares engine, the canonical LAlgorithm
demonstration — model trained and served entirely on the driver,
reference LAlgorithm.scala:45-133). Here the same pattern on the
port's taxonomy: a ``LocalAlgorithm`` whose closed-form ridge solve
runs in host NumPy in float64, as in the JAX package, and never touches
the card — the right placement for models this small, where a device
launch would cost more than the solve.

DataSource reads each entity's ``$set`` properties: numeric features
(``x0..``) plus a numeric target (``y``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from predictionio_tpu_torch.controller import (
    DataSource,
    Engine,
    FirstServing,
    IdentityPreparator,
    LocalAlgorithm,
    Params,
)


@dataclasses.dataclass(frozen=True)
class Query:
    features: tuple = ()


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    prediction: float = 0.0


@dataclasses.dataclass(frozen=True)
class DSParams(Params):
    app_name: str = ""
    entity_type: str = "point"
    features: tuple = ("x0", "x1")
    target: str = "y"


@dataclasses.dataclass(frozen=True)
class TrainingData:
    X: np.ndarray  # [N, F]
    y: np.ndarray  # [N]


class PointDataSource(DataSource):
    params_class = DSParams

    def read_training(self, ctx) -> TrainingData:
        p = self.params
        props = ctx.event_store().aggregate_properties(
            p.app_name, p.entity_type, required=list(p.features) + [p.target])
        rows, targets = [], []
        for _, pm in sorted(props.items()):
            rows.append([pm.get(f, float) for f in p.features])
            targets.append(pm.get(p.target, float))
        if not rows:
            raise ValueError(f"no {p.entity_type!r} entities with "
                             f"{list(p.features) + [p.target]} for app {p.app_name!r}")
        return TrainingData(X=np.asarray(rows, dtype=np.float64),
                            y=np.asarray(targets, dtype=np.float64))


@dataclasses.dataclass(frozen=True)
class RidgeParams(Params):
    lambda_: float = 1e-6


@dataclasses.dataclass(frozen=True)
class RidgeModel:
    weights: np.ndarray    # [F]
    intercept: float


class RidgeRegressionAlgorithm(LocalAlgorithm):
    params_class = RidgeParams
    query_class = Query

    def train(self, ctx, td: TrainingData) -> RidgeModel:
        X = np.concatenate([td.X, np.ones((len(td.X), 1))], axis=1)
        A = X.T @ X + self.params.lambda_ * np.eye(X.shape[1])
        w = np.linalg.solve(A, X.T @ td.y)
        return RidgeModel(weights=w[:-1], intercept=float(w[-1]))

    def predict(self, model: RidgeModel, query: Query) -> PredictedResult:
        x = np.asarray(query.features, dtype=np.float64)
        if x.shape != model.weights.shape:
            raise ValueError(f"query has {x.size} features; model expects "
                             f"{model.weights.size}")
        return PredictedResult(prediction=float(x @ model.weights + model.intercept))


def engine_factory() -> Engine:
    return Engine(
        data_source_class_map=PointDataSource,
        preparator_class_map=IdentityPreparator,
        algorithm_class_map={"ridge": RidgeRegressionAlgorithm},
        serving_class_map=FirstServing,
    )
