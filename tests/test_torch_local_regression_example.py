"""The port's ``examples_torch/local-regression`` on the CPU: the
pure-``LocalAlgorithm`` pattern, a closed-form ridge regression over
``$set`` properties solved in host NumPy in float64, as in JAX.

- the JAX example's scenarios (``tests/test_local_regression_example.py``)
  replayed on the port with the same events and assertions;
- held against the JAX example on the same events (its exact plane and a
  noisy one): the design matrix and targets equal, the weights, intercept
  and every prediction within 1e-12;
- its engine.json equal to the JAX example's.
"""

from __future__ import annotations

import numpy as np
import pytest

from predictionio_tpu.workflow.context import EngineContext as JaxEngineContext
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.workflow.train import run_train
from torch_examples import (  # noqa: F401  (example_model_dir: autouse)
    PORT_EXAMPLES,
    assert_same_variant,
    cpu_ctx,
    engine_json,
    example_model_dir,
    jax_engine,
    port_engine,
    port_store,
    twin_stores,
)

NAME = "local-regression"
APP = "RegressionApp"
RIDGE_TOL = 1e-12


@pytest.fixture
def example_engine():
    with port_engine(NAME) as engine:
        yield engine


def point_events(noise: float = 0.0, seed: int = 11) -> list[Event]:
    """The JAX test's points on the plane y = 2*x0 - 3*x1 + 5 (plus
    seeded noise when ``noise``)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(40):
        x0, x1 = float(rng.uniform(-5, 5)), float(rng.uniform(-5, 5))
        y = 2 * x0 - 3 * x1 + 5 + (float(rng.normal(0, noise)) if noise else 0.0)
        out.append(Event(event="$set", entity_type="point", entity_id=f"pt{k}",
                         properties=DataMap({"x0": x0, "x1": x1, "y": y})))
    return out


def test_recovers_the_plane(example_engine):
    storage = port_store(APP, point_events())
    algo = example_engine.RidgeRegressionAlgorithm(example_engine.RidgeParams(lambda_=1e-8))
    ds = example_engine.PointDataSource(example_engine.DSParams(app_name=APP))
    ctx = cpu_ctx(storage)
    model = algo.train(ctx, ds.read_training(ctx))
    np.testing.assert_allclose(model.weights, [2.0, -3.0], atol=1e-6)
    assert model.intercept == pytest.approx(5.0, abs=1e-6)
    out = algo.predict(model, example_engine.Query(features=(2.0, 3.0)))
    assert out.prediction == pytest.approx(2 * 2.0 - 3 * 3.0 + 5, abs=1e-6)
    with pytest.raises(ValueError, match="features"):
        algo.predict(model, example_engine.Query(features=(1.0,)))


def test_placement_is_local(example_engine):
    assert example_engine.RidgeRegressionAlgorithm.placement == "local"


def test_query_class_declared_for_wire_binding(example_engine):
    assert example_engine.RidgeRegressionAlgorithm.query_class is example_engine.Query


def test_full_train_workflow_from_variant(example_engine):
    storage = port_store(APP, point_events())
    outcome = run_train(variant=engine_json(PORT_EXAMPLES, NAME), ctx=cpu_ctx(storage))
    assert outcome.status == "COMPLETED"


def test_engine_json_equals_jax():
    assert_same_variant(NAME)


@pytest.mark.parametrize("noise,lam", [(0.0, 1e-8), (0.5, 0.001), (2.0, 3.0)])
def test_ridge_equals_jax(example_engine, noise, lam):
    jmod = jax_engine(NAME)
    port_storage, jax_storage = twin_stores(APP, point_events(noise))
    out = []
    for module, ctx in ((example_engine, cpu_ctx(port_storage)),
                        (jmod, JaxEngineContext(storage=jax_storage))):
        algo = module.RidgeRegressionAlgorithm(module.RidgeParams(lambda_=lam))
        td = module.PointDataSource(module.DSParams(app_name=APP)).read_training(ctx)
        out.append((module, algo, td, algo.train(ctx, td)))
    (_, palgo, ptd, pmodel), (_, jalgo, jtd, jmodel) = out
    assert ptd.X.dtype == np.float64 and pmodel.weights.dtype == np.float64
    np.testing.assert_array_equal(ptd.X, jtd.X)
    np.testing.assert_array_equal(ptd.y, jtd.y)
    np.testing.assert_allclose(pmodel.weights, jmodel.weights, rtol=RIDGE_TOL, atol=RIDGE_TOL)
    assert abs(pmodel.intercept - jmodel.intercept) <= RIDGE_TOL
    for features in ((2.0, 3.0), (-4.5, 0.25), (0.0, 0.0)):
        got = palgo.predict(pmodel, example_engine.Query(features=features)).prediction
        want = jalgo.predict(jmodel, jmod.Query(features=features)).prediction
        assert abs(got - want) <= RIDGE_TOL
