"""The port's
``examples_torch/similarproduct-add-and-return-item-properties`` on the
CPU: required title/date/imdbUrl item properties read at train time,
every returned score enriched with them.

- the JAX example's scenarios (``tests/test_item_properties_example.py``)
  replayed on the port with the same events and assertions, through
  ``run_train``, the deploy wiring and the engine server over HTTP;
- held against the JAX example on the same events: the properties read
  equal; the ALS factors (both packages' normal equations in f32 and
  solved exactly, the port from JAX's initial draw;
  ``torch_examples.train_exactly`` says why) within a relative Frobenius
  distance of 1e-3; the port serving JAX's trained factors, ids and order
  equal (a near-tie, JAX scores within 1e-6, compares as a set), scores
  within 1e-5 and the enrichment equal;
- its engine.json equal to the JAX example's.
"""

from __future__ import annotations

import numpy as np
import pytest

from predictionio_tpu.workflow.context import EngineContext as JaxEngineContext
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.templates.similarproduct import Query
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

NAME = "similarproduct-add-and-return-item-properties"
APP = "RichItemApp"


@pytest.fixture
def example_engine():
    with port_engine(NAME) as engine:
        yield engine


def rich_events(complete: bool = True) -> list[Event]:
    """The JAX test's store: 16 items $set with title/date/imdbUrl (i3
    without imdbUrl when not ``complete``), two view communities."""
    rng = np.random.default_rng(12)
    out = []
    for i in range(16):
        props = {"title": f"title for i{i}", "date": str(1990 + i),
                 "imdbUrl": f"http://imdb.com/i{i}"}
        if not complete and i == 3:
            del props["imdbUrl"]
        out.append(Event(event="$set", entity_type="item", entity_id=f"i{i}",
                         properties=DataMap(props)))
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


def test_results_are_property_enriched(example_engine):
    storage = port_store(APP, rich_events())
    outcome = run_train(variant=_variant(), ctx=cpu_ctx(storage))
    assert outcome.status == "COMPLETED"
    _, _, models = deployed(example_engine, _variant(), storage, outcome.instance_id)
    # the persisted round trip preserves the properties map
    assert models[0].item_props["i5"]["title"] == "title for i5"
    with engine_server(storage, outcome.instance_id) as post:
        scores = post({"items": ["i2"], "num": 4})["itemScores"]
    assert len(scores) == 4
    for s in scores:
        i = s["item"]
        # full enrichment on the wire (reference ItemScore parity)
        assert s["title"] == f"title for {i}"
        assert s["date"] == str(1990 + int(i[1:]))
        assert s["imdbUrl"] == f"http://imdb.com/{i}"
        assert np.isfinite(s["score"])


def test_missing_property_fails_training_loudly(example_engine):
    storage = port_store(APP, rich_events(complete=False))
    with pytest.raises(ValueError, match="imdbUrl"):
        run_train(variant=_variant(), ctx=cpu_ctx(storage))


def test_engine_json_equals_jax():
    assert_same_variant(NAME)


def test_answers_equal_jax(example_engine, monkeypatch):
    jmod = jax_engine(NAME)
    train_exactly(monkeypatch)
    port_storage, jax_storage = twin_stores(APP, rich_events())
    (palgos, pmodels, _), (jalgos, jmodels) = train_both(
        example_engine, jmod, _variant(), port_storage, jax_storage, JaxEngineContext)
    assert pmodels[0].item_props == jmodels[0].item_props
    assert_factors_close(pmodels[0].als, jmodels[0].als)
    carried = example_engine.RichModel(als=port_als(jmodels[0].als),
                                       categories=jmodels[0].categories,
                                       item_props=jmodels[0].item_props)
    for kw in (dict(items=("i2",), num=4), dict(items=("i1", "i5"), num=10),
               dict(items=("i0",), num=6, white_list=("i2", "i4", "i9")),
               dict(items=("i3",), num=5, black_list=("i1",)), dict(items=("nope",), num=3)):
        got = palgos[0].predict(carried, Query(**kw))
        want = jalgos[0].predict(jmodels[0], jmod.Query(**kw))
        assert_same_scores(got, want)
        assert {(s.item, s.title, s.date, s.imdb_url) for s in got.item_scores} == \
            {(s.item, s.title, s.date, s.imdb_url) for s in want.item_scores}
