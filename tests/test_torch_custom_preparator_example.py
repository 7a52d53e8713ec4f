"""The port's ``examples_torch/recommendation-custom-preparator`` on the
CPU: a Preparator with its own params drops no-train items from the
ratings before training, so excluded items have no factors and can
never be recommended.

- the JAX example's scenarios
  (``tests/test_custom_preparator_example.py``) replayed on the port with
  the same events and assertions;
- held against the JAX example on the same events and the same no-train
  file: the prepared id maps equal; the ALS factors (both packages' normal
  equations in f32 and solved exactly, the port from JAX's initial draw;
  ``torch_examples.train_exactly`` says why) within a relative Frobenius
  distance of 1e-3; the port serving JAX's trained factors, ids and order
  equal (a near-tie, JAX scores within 1e-6, compares as a set) and scores
  within 1e-5;
- its engine.json equal to the JAX example's.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from predictionio_tpu.templates.recommendation import Query as JaxQuery
from predictionio_tpu.workflow.context import EngineContext as JaxEngineContext
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.templates.recommendation import Query
from predictionio_tpu_torch.workflow.persistence import load_models
from predictionio_tpu_torch.workflow.train import run_train
from torch_examples import (  # noqa: F401  (example_model_dir: autouse)
    PORT_EXAMPLES,
    assert_factors_close,
    assert_same_scores,
    assert_same_variant,
    cpu_ctx,
    example_model_dir,
    jax_engine,
    port_als,
    port_engine,
    port_store,
    train_exactly,
    train_both,
    twin_stores,
)

NAME = "recommendation-custom-preparator"
APP = "CustomPreparatorApp"


@pytest.fixture
def example_engine():
    with port_engine(NAME) as engine:
        yield engine


def rating_events() -> list[Event]:
    """The JAX test's store: two taste clusters of 5.0 ratings."""
    rng = np.random.default_rng(5)
    return [Event(event="rate", entity_type="user", entity_id=f"u{u}",
                  target_entity_type="item", target_entity_id=f"i{i}",
                  properties=DataMap({"rating": 5.0}))
            for u in range(16) for i in range(12)
            if i % 2 == u % 2 and rng.random() < 0.9]


def test_shipped_engine_json_binds(example_engine):
    with open(PORT_EXAMPLES / NAME / "engine.json") as f:
        variant = json.load(f)
    eng = example_engine.engine_factory()
    ep = eng.params_from_variant_json(variant)
    assert ep.preparator_params[1].filepath == "no_train_items.txt"
    assert ep.algorithm_params_list[0][1].num_iterations == 10


def test_excluded_items_have_no_factors(example_engine, tmp_path):
    no_train = tmp_path / "no_train_items.txt"
    no_train.write_text("i0\ni4\n")
    variant = {
        "id": "custom-preparator",
        "engineFactory": "engine.engine_factory",
        "datasource": {"params": {"app_name": APP}},
        "preparator": {"params": {"filepath": str(no_train)}},
        "algorithms": [{"name": "als", "params": {"rank": 8, "num_iterations": 8,
                                                  "lambda_": 0.05, "seed": 1,
                                                  "use_mesh": False}}],
    }
    storage = port_store(APP, rating_events())
    outcome = run_train(variant=variant, ctx=cpu_ctx(storage))
    assert outcome.status == "COMPLETED"

    eng = example_engine.engine_factory()
    ep = eng.params_from_variant_json(variant)
    ctx = cpu_ctx(storage)
    models = eng.prepare_deploy(ctx, ep, load_models(storage, outcome.instance_id, "cpu"))
    _, _, algos, serving = eng.make_components(ep)

    # excluded items are absent from the model's id space entirely
    model = models[0]
    assert "i0" not in model.item_ids and "i4" not in model.item_ids
    assert "i2" in model.item_ids
    # and therefore never appear in any user's recommendations
    for user in ("u0", "u2", "u5"):
        q = serving.supplement(Query(user=user, num=8))
        served = serving.serve(q, [a.predict(m, q) for a, m in zip(algos, models)])
        items = [s.item for s in served.item_scores]
        assert "i0" not in items and "i4" not in items

    # an empty exclusion file trains on everything (control)
    no_train.write_text("")
    outcome2 = run_train(variant=variant, ctx=ctx)
    models2 = eng.prepare_deploy(ctx, ep, load_models(storage, outcome2.instance_id, "cpu"))
    assert "i0" in models2[0].item_ids


def test_engine_json_equals_jax():
    assert_same_variant(NAME)


def test_answers_equal_jax(example_engine, tmp_path, monkeypatch):
    jmod = jax_engine(NAME)
    no_train = tmp_path / "no_train_items.txt"
    no_train.write_text("i0\ni4\ni7\n")
    variant = {"datasource": {"params": {"app_name": APP}},
               "preparator": {"params": {"filepath": str(no_train)}},
               "algorithms": [{"name": "als", "params": {
                   "rank": 6, "numIterations": 6, "lambda": 0.05, "seed": 2,
                   "use_mesh": False}}]}
    train_exactly(monkeypatch)
    port_storage, jax_storage = twin_stores(APP, rating_events())
    (palgos, pmodels, ppd), (jalgos, jmodels) = train_both(
        example_engine, jmod, variant, port_storage, jax_storage, JaxEngineContext)
    assert ppd.item_ids.id_to_ix.to_dict() == jmodels[0].item_ids.id_to_ix.to_dict()
    assert not {"i0", "i4", "i7"} & set(ppd.item_ids.id_to_ix.to_dict())
    assert_factors_close(pmodels[0], jmodels[0])
    carried = port_als(jmodels[0])
    for user, num in (("u0", 5), ("u3", 8), ("u10", 12), ("nobody", 3)):
        assert_same_scores(palgos[0].predict(carried, Query(user=user, num=num)),
                           jalgos[0].predict(jmodels[0], JaxQuery(user=user, num=num)))
