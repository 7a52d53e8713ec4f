"""The port's ``examples_torch/classification-custom-attributes`` on the
CPU: categorical attribute featurization with fixed maps, the
required-properties filter, a random forest served through the port's
device vote walk, string-attribute queries.

- the JAX example's scenarios
  (``tests/test_custom_attributes_example.py``) replayed on the port with
  the same events and assertions, through ``run_train``, the deploy wiring
  and the engine server over HTTP;
- the pickled model's device node tables come back on the deploy's device,
  equal to its host tables;
- held against the JAX example on the same events: the features, labels
  and label map equal; the forest's node tables equal (host CART growth
  with the same rng draws); votes and the served label and scores equal
  for every query;
- its engine.json equal to the JAX example's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from predictionio_tpu.workflow.context import EngineContext as JaxEngineContext
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.workflow.persistence import load_models
from predictionio_tpu_torch.workflow.train import run_train
from torch_examples import (  # noqa: F401  (example_model_dir: autouse)
    PORT_EXAMPLES,
    assert_same_variant,
    cpu_ctx,
    deployed,
    engine_json,
    engine_server,
    example_model_dir,
    jax_engine,
    port_engine,
    port_store,
    train_both,
    twin_stores,
)

NAME = "classification-custom-attributes"
APP = "CustomAttrApp"
TABLES = ("feature", "threshold", "left", "right", "leaf_class")


@pytest.fixture
def example_engine():
    with port_engine(NAME) as engine:
        yield engine


def user_events() -> list[Event]:
    """The JAX test's store: 120 users whose plan follows education
    (College -> premium), and one incomplete user."""
    rng = np.random.default_rng(23)
    genders = ["Male", "Female"]
    educations = ["No School", "High School", "College"]
    out = []
    for u in range(120):
        gender = genders[int(rng.integers(0, 2))]
        education = educations[int(rng.integers(0, 3))]
        age = float(rng.integers(18, 70))
        out.append(Event(event="$set", entity_type="user", entity_id=f"u{u}",
                         properties=DataMap({
                             "plan": "premium" if education == "College" else "basic",
                             "gender": gender, "age": age, "education": education})))
    # incomplete users are skipped, not a training failure
    out.append(Event(event="$set", entity_type="user", entity_id="incomplete",
                     properties=DataMap({"plan": "basic", "age": 40.0})))
    return out


def _trained(example_engine):
    storage = port_store(APP, user_events())
    variant = engine_json(PORT_EXAMPLES, NAME)
    outcome = run_train(variant=variant, ctx=cpu_ctx(storage))
    assert outcome.status == "COMPLETED"
    return storage, variant, outcome.instance_id


def test_categorical_query_over_http(example_engine):
    storage, _, instance_id = _trained(example_engine)
    with engine_server(storage, instance_id) as post:
        grad = post({"gender": "Female", "age": 25, "education": "College"})
        assert grad["label"] == "premium", grad
        dropout = post({"gender": "Male", "age": 55, "education": "No School"})
        assert dropout["label"] == "basic", dropout
        # scores are normalized vote shares over the label set
        assert set(grad["scores"]) == {"premium", "basic"}
        assert abs(sum(grad["scores"].values()) - 1.0) < 1e-6


def test_engine_json_binds_forest_params(example_engine):
    eng = example_engine.engine_factory()
    params = eng.params_from_variant_json(engine_json(PORT_EXAMPLES, NAME)) \
        .algorithm_params_list[0][1]
    assert params.num_trees == 10
    assert params.max_depth == 5


def test_unknown_categorical_query_is_clear_error(example_engine):
    storage, variant, instance_id = _trained(example_engine)
    algos, _, models = deployed(example_engine, variant, storage, instance_id)
    with pytest.raises(ValueError, match="unknown education"):
        algos[0].predict(models[0], example_engine.Query(gender="Male", age=30,
                                                         education="PhD"))


def test_incomplete_users_are_skipped(example_engine):
    storage = port_store(APP, user_events())
    ds = example_engine.CustomAttrDataSource(
        example_engine.CustomAttrDataSource.params_class(app_name=APP))
    assert len(ds.read_training(cpu_ctx(storage)).features) == 120        # not 121


def test_pickled_device_tables_load_on_the_deploy_device(example_engine):
    storage, _, instance_id = _trained(example_engine)
    model = load_models(storage, instance_id, torch.device("cpu"))[0]
    assert len(model.tables) == len(TABLES)
    for name, table in zip(TABLES, model.tables):
        assert table.device.type == "cpu"
        np.testing.assert_array_equal(table.numpy(), getattr(model.forest, name))


def test_engine_json_equals_jax():
    assert_same_variant(NAME)


def test_forest_and_votes_equal_jax(example_engine):
    jmod = jax_engine(NAME)
    variant = engine_json(PORT_EXAMPLES, NAME)
    port_storage, jax_storage = twin_stores(APP, user_events())
    (palgos, pmodels, ptd), (jalgos, jmodels) = train_both(
        example_engine, jmod, variant, port_storage, jax_storage, JaxEngineContext)
    jtd = jmod.CustomAttrDataSource(jmod.CustomAttrDataSource.params_class(
        app_name=APP)).read_training(JaxEngineContext(storage=jax_storage))
    np.testing.assert_array_equal(ptd.features, jtd.features)
    np.testing.assert_array_equal(ptd.labels, jtd.labels)
    assert ptd.label_map.to_dict() == jtd.label_map.to_dict()
    pforest, jforest = pmodels[0].forest, jmodels[0].forest
    for name in TABLES:
        np.testing.assert_array_equal(getattr(pforest, name), np.asarray(getattr(jforest, name)))
    assert (pforest.max_depth, pforest.num_classes) == (jforest.max_depth, jforest.num_classes)
    rng = np.random.default_rng(1)
    for gender in ("Male", "Female"):
        for education in ("No School", "High School", "College"):
            for age in rng.integers(18, 70, size=3).tolist() + [29.5, 30.0]:
                kw = dict(gender=gender, age=float(age), education=education)
                got = palgos[0].predict(pmodels[0], example_engine.Query(**kw))
                want = jalgos[0].predict(jmodels[0], jmod.Query(**kw))
                assert (got.label, got.scores) == (want.label, want.scores)
    X = ptd.features[:40]
    np.testing.assert_array_equal(
        example_engine.predict_forest(pforest, X, tables=pmodels[0].tables),
        np.asarray(jmod.predict_forest(jforest, X)))
