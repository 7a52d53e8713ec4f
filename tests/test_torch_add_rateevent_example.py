"""The port's ``examples_torch/similarproduct-add-rateevent`` on the CPU:
rate events with values, keep-latest dedup per (user, item), explicit
ALS training.

- the JAX example's scenarios (``tests/test_add_rateevent_example.py``)
  replayed on the port with the same events and assertions, through
  ``run_train`` and the engine server over HTTP;
- held against the JAX example on the same events (a re-rated pair among
  them): the training triples equal; the explicit ALS factors (both
  packages' normal equations in f32 and solved exactly, the port from
  JAX's initial draw; ``torch_examples.train_exactly`` says why) within a
  relative Frobenius distance of 1e-3; the port serving JAX's trained
  factors, ids and order equal (a near-tie, JAX scores within 1e-6,
  compares as a set) and scores within 1e-5;
- its engine.json equal to the JAX example's.
"""

from __future__ import annotations

import datetime

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

NAME = "similarproduct-add-rateevent"
APP = "RateEventApp"
T0 = datetime.datetime(2024, 1, 1, tzinfo=datetime.timezone.utc)


@pytest.fixture
def example_engine():
    with port_engine(NAME) as engine:
        yield engine


def rate_events() -> list[Event]:
    """The JAX test's store: two taste communities rating 16 items 1-5."""
    rng = np.random.default_rng(17)
    out = []
    for u in range(20):
        for i in range(16):
            if rng.random() < 0.7:
                liked = i % 2 == u % 2
                rating = float(rng.integers(4, 6) if liked else rng.integers(1, 3))
                out.append(Event(event="rate", entity_type="user", entity_id=f"u{u}",
                                 target_entity_type="item", target_entity_id=f"i{i}",
                                 properties=DataMap({"rating": rating})))
    return out


def fickle_events() -> list[Event]:
    """One user re-rating i0 over three days: only the last counts."""
    return [Event(event="rate", entity_type="user", entity_id="fickle",
                  target_entity_type="item", target_entity_id="i0",
                  properties=DataMap({"rating": rating}),
                  event_time=T0 + datetime.timedelta(days=day))
            for day, rating in ((0, 1.0), (1, 2.0), (2, 5.0))]


def _variant() -> dict:
    variant = engine_json(PORT_EXAMPLES, NAME)
    variant["algorithms"][0]["params"]["use_mesh"] = False
    return variant


def test_keep_latest_rating_per_pair(example_engine):
    """A re-rate REPLACES the old value — verified at the DataSource."""
    storage = port_store(APP, rate_events() + fickle_events())
    ds = example_engine.RateEventDataSource(
        example_engine.RateEventDataSource.params_class(app_name=APP))
    td = ds.read_training(cpu_ctx(storage))
    sel = [(u, i, r) for u, i, r in zip(td.users, td.items, td.ratings) if u == "fickle"]
    assert sel == [("fickle", "i0", 5.0)], sel


def test_explicit_rate_training_and_serving(example_engine):
    storage = port_store(APP, rate_events())
    outcome = run_train(variant=_variant(), ctx=cpu_ctx(storage))
    assert outcome.status == "COMPLETED"
    with engine_server(storage, outcome.instance_id) as post:
        recs = [s["item"] for s in post({"items": ["i2"], "num": 4})["itemScores"]]
    assert len(recs) == 4
    assert "i2" not in recs        # query item excluded
    # explicit ratings separate the taste communities
    even = sum(1 for i in recs if int(i[1:]) % 2 == 0)
    assert even >= 3, recs


def test_engine_json_equals_jax():
    assert_same_variant(NAME)


def test_answers_equal_jax(example_engine, monkeypatch):
    jmod = jax_engine(NAME)
    train_exactly(monkeypatch)
    port_storage, jax_storage = twin_stores(APP, fickle_events() + rate_events())
    (palgos, pmodels, ppd), (jalgos, jmodels) = train_both(
        example_engine, jmod, _variant(), port_storage, jax_storage, JaxEngineContext)
    pdata = example_engine.RateEventDataSource(
        example_engine.RateEventDataSource.params_class(app_name=APP)).read_training(
            cpu_ctx(port_storage))
    jdata = jmod.RateEventDataSource(jmod.RateEventDataSource.params_class(
        app_name=APP)).read_training(JaxEngineContext(storage=jax_storage))
    assert list(zip(pdata.users, pdata.items, pdata.ratings)) == \
        list(zip(jdata.users, jdata.items, jdata.ratings))
    assert_factors_close(pmodels[0].als, jmodels[0].als)
    carried = SimilarModel(als=port_als(jmodels[0].als), categories=jmodels[0].categories)
    for kw in (dict(items=("i2",), num=4), dict(items=("i1", "i3"), num=10),
               dict(items=("i0",), num=15), dict(items=("i5",), num=5, white_list=("i7", "i9"))):
        assert_same_scores(palgos[0].predict(carried, Query(**kw)),
                           jalgos[0].predict(jmodels[0], JaxQuery(**kw)))
