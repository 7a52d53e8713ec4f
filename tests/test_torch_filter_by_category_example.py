"""The port's ``examples_torch/recommendation-filter-by-category`` on the
CPU: item categories from ``$set`` events restrict recommendations
before the top-k, and the trained model persists as a pickle blob.

- the JAX example's scenario
  (``tests/test_filter_by_category_example.py``) replayed on the port with
  the same events and assertions;
- the pickled ``CategoryModel`` loads through ``load_models`` with its ALS
  factor tables on the deploy context's device;
- held against the JAX example on the same events: the categories read
  equal; the ALS factors (both packages' normal equations in f32 and
  solved exactly, the port from JAX's initial draw;
  ``torch_examples.train_exactly`` says why) within a relative Frobenius
  distance of 1e-3; the port serving JAX's trained factors, with and
  without category filters, ids and order equal (a near-tie, JAX scores
  within 1e-6, compares as a set) and scores within 1e-5;
- its engine.json equal to the JAX example's.
"""

from __future__ import annotations

import json

import pytest
import torch

from predictionio_tpu.workflow.context import EngineContext as JaxEngineContext
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.workflow.persistence import load_models
from predictionio_tpu_torch.workflow.train import run_train
from torch_examples import (  # noqa: F401  (example_model_dir: autouse)
    PORT_EXAMPLES,
    assert_factors_close,
    assert_same_scores,
    assert_same_variant,
    components,
    cpu_ctx,
    example_model_dir,
    jax_engine,
    port_als,
    port_engine,
    port_store,
    train_both,
    train_exactly,
    twin_stores,
)

NAME = "recommendation-filter-by-category"
APP = "FilterCategoryApp"
VARIANT = {
    "id": "filter-by-category",
    "engineFactory": "engine.engine_factory",
    "datasource": {"params": {"app_name": APP}},
    "algorithms": [{"name": "als", "params": {"rank": 8, "num_iterations": 8,
                                              "lambda_": 0.05, "seed": 1, "use_mesh": False,
                                              "exclude_seen": False}}],
}


@pytest.fixture
def example_engine():
    with port_engine(NAME) as engine:
        yield engine


def category_events() -> list[Event]:
    """The JAX test's store: even items in "even", odd in "odd", i0/i1 in
    both; every user rates the items of its own parity."""
    out = []
    for i in range(12):
        cats = ["even" if i % 2 == 0 else "odd"]
        if i < 2:
            cats = ["even", "odd"]
        out.append(Event(event="$set", entity_type="item", entity_id=f"i{i}",
                         properties=DataMap({"categories": cats})))
    for u in range(16):
        for i in range(12):
            if i % 2 == u % 2:
                out.append(Event(event="rate", entity_type="user", entity_id=f"u{u}",
                                 target_entity_type="item", target_entity_id=f"i{i}",
                                 properties=DataMap({"rating": 5.0})))
    return out


def test_category_filtered_recommendations(example_engine):
    storage = port_store(APP, category_events())
    outcome = run_train(variant=VARIANT, ctx=cpu_ctx(storage))
    assert outcome.status == "COMPLETED"

    eng = example_engine.engine_factory()
    ep = eng.params_from_variant_json(VARIANT)
    ctx = cpu_ctx(storage)
    models = eng.prepare_deploy(ctx, ep, load_models(storage, outcome.instance_id, "cpu"))
    _, _, algos, serving = eng.make_components(ep)
    Query = example_engine.Query

    def ask(**kw):
        q = serving.supplement(Query(**kw))
        return serving.serve(q, [a.predict(m, q) for a, m in zip(algos, models)])

    # no categories: unrestricted
    assert len(ask(user="u0", num=6).item_scores) == 6
    # category restriction: only odd-category items (incl. the dual i0/i1)
    items = [s.item for s in ask(user="u0", num=6, categories=("odd",)).item_scores]
    assert items and all(int(i[1:]) % 2 == 1 or i in ("i0", "i1") for i in items)
    # unknown category: empty-eligibility semantics -> nothing served
    assert ask(user="u0", num=6, categories=("nope",)).item_scores == ()
    # the shipped engine.json binds as-is
    with open(PORT_EXAMPLES / NAME / "engine.json") as f:
        shipped = json.load(f)
    assert eng.params_from_variant_json(shipped).algorithm_params_list[0][1].rank == 10


def test_pickled_model_loads_on_the_deploy_device(example_engine):
    """The blob holds the whole CategoryModel; load_models puts its ALS
    factor tables on the deploy's device and it serves from there."""
    storage = port_store(APP, category_events())
    outcome = run_train(variant=VARIANT, ctx=cpu_ctx(storage))
    persisted = load_models(storage, outcome.instance_id, torch.device("cpu"))
    model = persisted[0]
    assert isinstance(model, example_engine.CategoryModel)
    for table in (model.als.user_factors, model.als.item_factors):
        assert isinstance(table, torch.Tensor) and table.device.type == "cpu"
        assert table.dtype == torch.float32
    assert model.categories["i0"] == ("even", "odd")
    algo = components(example_engine, VARIANT)[2][0]
    answer = algo.predict(model, example_engine.Query(user="u3", num=4, categories=("even",)))
    assert [s.item for s in answer.item_scores] and all(
        s.item in ("i0", "i1") or int(s.item[1:]) % 2 == 0 for s in answer.item_scores)


def test_engine_json_equals_jax():
    assert_same_variant(NAME)


def test_answers_equal_jax(example_engine, monkeypatch):
    jmod = jax_engine(NAME)
    variant = {"datasource": {"params": {"app_name": APP}},
               "algorithms": [{"name": "als", "params": {
                   "rank": 6, "numIterations": 6, "lambda": 0.05, "seed": 2,
                   "exclude_seen": False}}]}
    train_exactly(monkeypatch)
    port_storage, jax_storage = twin_stores(APP, category_events())
    (palgos, pmodels, ppd), (jalgos, jmodels) = train_both(
        example_engine, jmod, variant, port_storage, jax_storage, JaxEngineContext)
    assert ppd.categories == jmodels[0].categories
    assert_factors_close(pmodels[0].als, jmodels[0].als)
    carried = example_engine.CategoryModel(als=port_als(jmodels[0].als),
                                           categories=jmodels[0].categories)
    for kw in (dict(user="u0", num=6), dict(user="u1", num=12, categories=("odd",)),
               dict(user="u4", num=5, categories=("even", "odd")),
               dict(user="u5", num=5, categories=("nope",)), dict(user="nobody", num=3)):
        assert_same_scores(palgos[0].predict(carried, example_engine.Query(**kw)),
                           jalgos[0].predict(jmodels[0], jmod.Query(**kw)))
