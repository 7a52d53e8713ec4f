"""The port's ``examples_torch/similarproduct-filterbyyear`` on the CPU: a
required item ``year`` read at train time, a query-time year filter,
year-enriched results.

- the JAX example's scenarios (``tests/test_filterbyyear_example.py``)
  replayed on the port with the same events and assertions, through
  ``run_train``, the deploy wiring and the engine server over HTTP;
- held against the JAX example on the same events: the years and the
  index-aligned year table equal; the ALS factors (both packages' normal
  equations in f32 and solved exactly, the port from JAX's initial draw;
  ``torch_examples.train_exactly`` says why) within a relative Frobenius
  distance of 1e-3; the port serving JAX's trained factors, ids and order
  equal (a near-tie, JAX scores within 1e-6, compares as a set), scores
  within 1e-5 and years equal;
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
    assert_factors_close,
    assert_same_scores,
    assert_same_variant,
    cpu_ctx,
    deployed,
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

NAME = "similarproduct-filterbyyear"
APP = "FilterByYearApp"


@pytest.fixture
def example_engine():
    with port_engine(NAME) as engine:
        yield engine


def year_events(with_years: bool = True) -> list[Event]:
    """The JAX test's store: 16 items $set with a year (or without one),
    two view communities."""
    rng = np.random.default_rng(11)
    out = [Event(event="$set", entity_type="item", entity_id=f"i{i}",
                 properties=DataMap({"year": 1990 + i} if with_years else {"other": 1}))
           for i in range(16)]
    for u in range(20):
        for i in range(16):
            if i % 2 == u % 2 and rng.random() < 0.8:
                out.append(Event(event="view", entity_type="user", entity_id=f"u{u}",
                                 target_entity_type="item", target_entity_id=f"i{i}",
                                 properties=DataMap({})))
    return out


def _variant() -> dict:
    variant = engine_json(PORT_EXAMPLES, NAME)
    variant["algorithms"][0]["params"]["use_mesh"] = False
    return variant


def test_year_filter_and_enriched_result(example_engine):
    storage = port_store(APP, year_events())
    outcome = run_train(variant=_variant(), ctx=cpu_ctx(storage))
    assert outcome.status == "COMPLETED"
    _, _, models = deployed(example_engine, _variant(), storage, outcome.instance_id)
    # the persisted round trip preserves the years map
    assert models[0].years["i7"] == 1997
    with engine_server(storage, outcome.instance_id) as post:
        base = post({"items": ["i2"], "num": 5})["itemScores"]
        assert base, "no similar items"
        # every score is year-enriched (reference ItemScore parity)
        for s in base:
            assert s["year"] == 1990 + int(s["item"][1:])
        # recommendFromYear filters strictly: year > 1997 only
        recent = post({"items": ["i2"], "num": 5, "recommendFromYear": 1997})["itemScores"]
        assert recent, "year filter returned nothing"
        assert all(s["year"] > 1997 for s in recent), recent
        # default (reference getOrElse(1)): everything eligible
        assert len(base) == 5


def test_missing_year_fails_training_loudly(example_engine):
    """A $set item without a year fails training: the instance is
    marked FAILED and the error surfaces."""
    storage = port_store(APP, year_events(with_years=False))
    with pytest.raises(ValueError, match="no 'year' property"):
        run_train(variant=_variant(), ctx=cpu_ctx(storage))
    instances = storage.get_meta_data_engine_instances().get_all()
    assert any(i.status == "FAILED" for i in instances)


def test_engine_json_equals_jax():
    assert_same_variant(NAME)


def test_answers_equal_jax(example_engine, monkeypatch):
    jmod = jax_engine(NAME)
    train_exactly(monkeypatch)
    port_storage, jax_storage = twin_stores(APP, year_events())
    (palgos, pmodels, _), (jalgos, jmodels) = train_both(
        example_engine, jmod, _variant(), port_storage, jax_storage, JaxEngineContext)
    assert pmodels[0].years == jmodels[0].years
    np.testing.assert_array_equal(pmodels[0].year_by_ix,
                                  np.asarray(jmodels[0].year_by_ix))
    assert_factors_close(pmodels[0].als, jmodels[0].als)
    carried = example_engine.YearModel(als=port_als(jmodels[0].als),
                                       categories=jmodels[0].categories,
                                       years=jmodels[0].years)
    for kw in (dict(items=("i2",), num=5), dict(items=("i2",), num=5, recommend_from_year=1997),
               dict(items=("i1", "i3"), num=10, recommend_from_year=2003),
               dict(items=("i4",), num=8, recommend_from_year=2100),
               dict(items=("i6",), num=6, black_list=("i8",))):
        got = palgos[0].predict(carried, example_engine.YearQuery(**kw))
        want = jalgos[0].predict(jmodels[0], jmod.YearQuery(**kw))
        assert_same_scores(got, want)
        assert {(s.item, s.year) for s in got.item_scores} == \
            {(s.item, s.year) for s in want.item_scores}
