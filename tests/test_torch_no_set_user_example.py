"""The port's ``examples_torch/similarproduct-no-set-user`` on the CPU:
the engine trains and serves with ZERO ``$set`` events of any kind
(users exist only as view-event subjects), the template default.

- the JAX example's scenario (``tests/test_no_set_user_example.py``)
  replayed on the port with the same events and assertions, over HTTP;
- held against the JAX example on the same events: the ALS factors (both
  packages' normal equations in f32 and solved exactly, the port from
  JAX's initial draw; ``torch_examples.train_exactly`` says why) within a
  relative Frobenius distance of 1e-3; the port serving JAX's trained
  factors, ids and order equal (a near-tie, JAX scores within 1e-6,
  compares as a set) and scores within 1e-5;
- its engine.json equal to the JAX example's.
"""

from __future__ import annotations

import numpy as np
import pytest

from predictionio_tpu.templates.similarproduct import Query as JaxQuery
from predictionio_tpu.workflow.context import EngineContext as JaxEngineContext
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.templates.similarproduct import Query, SimilarModel
from predictionio_tpu_torch.workflow.train import run_train
from torch_examples import (  # noqa: F401  (example_model_dir: autouse)
    PORT_EXAMPLES,
    assert_factors_close,
    assert_same_scores,
    assert_same_variant,
    cpu_ctx,
    engine_json,
    engine_server,
    example_model_dir,
    jax_engine,
    port_als,
    port_engine,
    port_store,
    train_both,
    train_exactly,
    twin_stores,
)

NAME = "similarproduct-no-set-user"
APP = "NoSetUserApp"


@pytest.fixture
def example_engine():
    with port_engine(NAME) as engine:
        yield engine


def view_events() -> list[Event]:
    """The JAX test's store: complete parity blocks of views plus sparse
    seeded cross-parity noise (p = 0.05); no $set at all."""
    rng = np.random.default_rng(19)
    return [Event(event="view", entity_type="user", entity_id=f"u{u}",
                  target_entity_type="item", target_entity_id=f"i{i}",
                  properties=DataMap({}))
            for u in range(20) for i in range(16)
            if i % 2 == u % 2 or rng.random() < 0.05]


def test_trains_and_serves_with_zero_set_events(example_engine):
    events = view_events()
    storage = port_store(APP, events)
    app_id = storage.get_meta_data_apps().get_by_name(APP).id
    # the property under test: NOTHING but view events in the store
    assert all(e.event == "view" for e in storage.get_events().find(app_id))
    assert events

    variant = engine_json(PORT_EXAMPLES, NAME)
    variant["algorithms"][0]["params"]["use_mesh"] = False
    outcome = run_train(variant=variant, ctx=cpu_ctx(storage))
    assert outcome.status == "COMPLETED"
    with engine_server(storage, outcome.instance_id) as post:
        recs = [s["item"] for s in post({"items": ["i2"], "num": 4})["itemScores"]]
    assert len(recs) == 4 and "i2" not in recs
    even = sum(1 for i in recs if int(i[1:]) % 2 == 0)
    assert even >= 3, recs


def test_engine_json_equals_jax():
    assert_same_variant(NAME)


def test_answers_equal_jax(example_engine, monkeypatch):
    jmod = jax_engine(NAME)
    variant = engine_json(PORT_EXAMPLES, NAME)
    train_exactly(monkeypatch)
    port_storage, jax_storage = twin_stores(APP, view_events())
    (palgos, pmodels, _), (jalgos, jmodels) = train_both(
        example_engine, jmod, variant, port_storage, jax_storage, JaxEngineContext)
    assert_factors_close(pmodels[0].als, jmodels[0].als)
    carried = SimilarModel(als=port_als(jmodels[0].als), categories=jmodels[0].categories)
    for kw in (dict(items=("i2",), num=4), dict(items=("i1", "i3"), num=8),
               dict(items=("i0",), num=15), dict(items=("i5",), num=5, black_list=("i7",)),
               dict(items=("nope",), num=4)):
        assert_same_scores(palgos[0].predict(carried, Query(**kw)),
                           jalgos[0].predict(jmodels[0], JaxQuery(**kw)))
