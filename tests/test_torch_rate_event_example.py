"""The port's ``examples_torch/ecommerce-train-with-rate-event`` on the
CPU: rate events with a rating property feed implicit ALS as confidence
weights, the latest rating per (user, item) wins.

- the JAX example's scenarios (``tests/test_rate_event_example.py``)
  replayed on the port with the same events and assertions;
- held against the JAX example on the same events: the training triples
  equal; the ALS factors (both packages' normal equations in f32 and
  solved exactly, the port from JAX's initial draw;
  ``torch_examples.train_exactly`` says why) within a relative Frobenius
  distance of 1e-3; the port serving JAX's trained factors (known users
  and the unknown-user fallback over the live store), ids and order equal
  (a near-tie, JAX scores within 1e-6, compares as a set) and scores
  within 1e-5;
- its engine.json equal to the JAX example's.
"""

from __future__ import annotations

from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from predictionio_tpu.core.datamap import DataMap as JaxDataMap
from predictionio_tpu.core.event import Event as JaxEvent
from predictionio_tpu.templates.ecommerce import Query as JaxQuery
from predictionio_tpu.workflow.context import EngineContext as JaxEngineContext
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.templates.ecommerce import ECommModel, Query
from predictionio_tpu_torch.workflow.train import run_train
from torch_examples import (  # noqa: F401  (example_model_dir: autouse)
    PORT_EXAMPLES,
    assert_factors_close,
    assert_same_scores,
    assert_same_variant,
    cpu_ctx,
    deployed,
    engine_json,
    example_model_dir,
    jax_engine,
    port_als,
    port_engine,
    port_store,
    train_both,
    train_exactly,
    twin_stores,
)

NAME = "ecommerce-train-with-rate-event"
APP = "RateEcommApp"


@pytest.fixture
def example_engine():
    with port_engine(NAME) as engine:
        yield engine


def rate_events() -> list[Event]:
    """The JAX test's store: ratings 4-5 in the user's cluster, 1-2
    outside it, all at t0; u0 re-rates i1 low at t0+1 min, then 5.0 at
    t0+5 min."""
    rng = np.random.default_rng(17)
    t0 = datetime.now(timezone.utc)
    out = []
    for u in range(20):
        for i in range(16):
            if rng.random() < 0.5:
                same = (i % 2) == (u % 2)
                rating = float(rng.integers(4, 6) if same else rng.integers(1, 3))
                out.append(Event(event="rate", entity_type="user", entity_id=f"u{u}",
                                 target_entity_type="item", target_entity_id=f"i{i}",
                                 properties=DataMap({"rating": rating}), event_time=t0))
    for minutes, rating in ((1, 1.0), (5, 5.0)):
        out.append(Event(event="rate", entity_type="user", entity_id="u0",
                         target_entity_type="item", target_entity_id="i1",
                         properties=DataMap({"rating": rating}),
                         event_time=t0 + timedelta(minutes=minutes)))
    return out


def _variant() -> dict:
    variant = engine_json(PORT_EXAMPLES, NAME)
    variant["algorithms"][0]["params"]["use_mesh"] = False
    return variant


def test_latest_rating_wins_and_weights_are_ratings(example_engine):
    storage = port_store(APP, rate_events())
    ds = example_engine.RateEventDataSource(example_engine.RateDataSourceParams(app_name=APP))
    td = ds.read_training(cpu_ctx(storage))
    by_pair = {(u, i): w for u, i, w in zip(td.users, td.items, td.weights)}
    assert by_pair[("u0", "i1")] == 5.0           # the re-rate superseded
    assert set(np.unique(td.weights)) <= {1.0, 2.0, 4.0, 5.0}
    assert len(td.users) == len(set(zip(td.users, td.items)))  # deduped


def test_trains_and_high_ratings_drive_recommendations(example_engine):
    storage = port_store(APP, rate_events())
    outcome = run_train(variant=_variant(), ctx=cpu_ctx(storage))
    assert outcome.status == "COMPLETED"
    algos, _, models = deployed(example_engine, _variant(), storage, outcome.instance_id)
    # high-rated (same-cluster) items dominate a cluster user's top-k
    recs = [s.item for s in algos[0].predict(models[0], Query(user="u2", num=4)).item_scores]
    assert recs
    even = sum(1 for i in recs if int(i[1:]) % 2 == 0)
    assert even >= len(recs) - 1, recs
    # the unknown-user fallback works on a rate-only app (similarEvents
    # routes at "rate"); the deploy wiring's load_model kept the context
    storage.get_events().insert(
        Event(event="rate", entity_type="user", entity_id="ghost", target_entity_type="item",
              target_entity_id="i2", properties=DataMap({"rating": 5.0})),
        storage.get_meta_data_apps().get_by_name(APP).id)
    assert algos[0].predict(models[0], Query(user="ghost", num=4)).item_scores, \
        "unknown-user fallback returned nothing"


def test_engine_json_equals_jax():
    assert_same_variant(NAME)


def test_answers_equal_jax(example_engine, monkeypatch):
    jmod = jax_engine(NAME)
    train_exactly(monkeypatch)
    port_storage, jax_storage = twin_stores(APP, rate_events())
    (palgos, pmodels, _), (jalgos, jmodels) = train_both(
        example_engine, jmod, _variant(), port_storage, jax_storage, JaxEngineContext)
    ptd = example_engine.RateEventDataSource(example_engine.RateDataSourceParams(
        app_name=APP)).read_training(cpu_ctx(port_storage))
    jtd = jmod.RateEventDataSource(jmod.RateDataSourceParams(app_name=APP)).read_training(
        JaxEngineContext(storage=jax_storage))
    assert list(zip(ptd.users, ptd.items, ptd.weights)) == \
        list(zip(jtd.users, jtd.items, jtd.weights))
    assert_factors_close(pmodels[0].als, jmodels[0].als)
    carried = ECommModel(als=port_als(jmodels[0].als), categories=jmodels[0].categories)
    # the same newcomer in both live stores: the fallback path
    ghost = dict(event="rate", entity_type="user", entity_id="ghost",
                 target_entity_type="item", target_entity_id="i2", event_id="ghost-1",
                 event_time=datetime(2030, 1, 1, tzinfo=timezone.utc))
    port_storage.get_events().insert(Event(**ghost, properties=DataMap({"rating": 5.0})),
                                     port_storage.get_meta_data_apps().get_by_name(APP).id)
    jax_storage.get_events().insert(JaxEvent(**ghost, properties=JaxDataMap({"rating": 5.0})),
                                    jax_storage.get_meta_data_apps().get_by_name(APP).id)
    for kw in (dict(user="u2", num=4), dict(user="u1", num=16), dict(user="u0", num=6),
               dict(user="u3", num=5, black_list=("i1", "i5")), dict(user="ghost", num=4),
               dict(user="nobody", num=4)):
        assert_same_scores(palgos[0].predict(carried, Query(**kw)),
                           jalgos[0].predict(jmodels[0], JaxQuery(**kw)))
