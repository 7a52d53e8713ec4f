"""The port's ``examples_torch/ecommerce-weighted-items`` on the CPU:
per-item score weights published live as a ``$set`` on the constraint
entity ``weightedItems``, re-read per query; for known users the
weights fold into the item-factor table on the factors' device.

- the JAX example's scenarios (``tests/test_weighted_items_example.py``)
  replayed on the port with the same events and assertions, through
  ``run_train``, the deploy wiring, the port's event server (the weights
  arrive over HTTP) and its engine server;
- the weighted copy of the ALS model keeps every other field of the base
  model, as JAX's ``dataclasses.replace`` does, and its factors stay on
  the model's device;
- held against the JAX example on the same events: the ALS factors (both
  packages' normal equations in f32 and solved exactly, the port from
  JAX's initial draw; ``torch_examples.train_exactly`` says why) within a
  relative Frobenius distance of 1e-3; the port serving JAX's trained
  factors under the same live weights (known users through the weighted
  table, a newcomer through the re-weighted cosine pool, a malformed group
  skipped), ids and order equal (a near-tie, JAX scores within 1e-6,
  compares as a set) and scores within 1e-5;
- its engine.json equal to the JAX example's.
"""

from __future__ import annotations

import json
import urllib.request
from datetime import datetime, timezone

import numpy as np
import pytest
import torch

from predictionio_tpu.core.datamap import DataMap as JaxDataMap
from predictionio_tpu.core.event import Event as JaxEvent
from predictionio_tpu.templates.ecommerce import Query as JaxQuery
from predictionio_tpu.workflow.context import EngineContext as JaxEngineContext
from predictionio_tpu_torch.api.event_server import EventServer, EventServerConfig
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.storage.base import AccessKey
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

NAME = "ecommerce-weighted-items"
APP = "WeightedEcommApp"
KEY = "weighted-key"


@pytest.fixture
def example_engine():
    with port_engine(NAME) as engine:
        yield engine


def view_events() -> list[Event]:
    """The JAX test's store: two view-taste clusters, no weights yet."""
    rng = np.random.default_rng(7)
    return [Event(event="view", entity_type="user", entity_id=f"u{u}",
                  target_entity_type="item", target_entity_id=f"i{i}", properties=DataMap({}))
            for u in range(20) for i in range(16)
            if i % 2 == u % 2 and rng.random() < 0.85]


def _variant() -> dict:
    variant = engine_json(PORT_EXAMPLES, NAME)
    variant["algorithms"][0]["params"]["use_mesh"] = False
    return variant


def _trained(example_engine):
    """(storage, instance id, algorithms, models) after run_train and the
    deploy wiring (one set of algorithm instances loads and serves)."""
    storage = port_store(APP, view_events())
    storage.get_meta_data_access_keys().insert(
        AccessKey(KEY, storage.get_meta_data_apps().get_by_name(APP).id, []))
    outcome = run_train(variant=_variant(), ctx=cpu_ctx(storage))
    assert outcome.status == "COMPLETED"
    algos, _, models = deployed(example_engine, _variant(), storage, outcome.instance_id)
    return storage, outcome.instance_id, algos, models


def _insert(storage, event: Event) -> None:
    storage.get_events().insert(event, storage.get_meta_data_apps().get_by_name(APP).id)


def _weights(groups) -> Event:
    return Event(event="$set", entity_type="constraint", entity_id="weightedItems",
                 properties=DataMap({"weights": groups}))


def test_unknown_user_cosine_path_is_weighted(example_engine):
    """The unknown-user fallback ranks by cosine similarity, which
    normalizes a table scaling away: the similarity scores are weighted
    instead."""
    storage, _, algos, models = _trained(example_engine)
    algo, model = algos[0], models[0]
    for i in (2, 4):   # an unknown user with recent views
        _insert(storage, Event(event="view", entity_type="user", entity_id="ghost",
                               target_entity_type="item", target_entity_id=f"i{i}",
                               properties=DataMap({})))
    base = algo.predict(model, Query(user="ghost", num=4))
    assert base.item_scores, "unknown-user fallback returned nothing"
    target = base.item_scores[-1].item
    _insert(storage, _weights([{"items": [target], "weight": 50.0}]))
    boosted = algo.predict(model, Query(user="ghost", num=4))
    assert boosted.item_scores[0].item == target, (
        target, [(s.item, s.score) for s in boosted.item_scores])


def test_shipped_engine_json_binds(example_engine):
    eng = example_engine.engine_factory()
    params = eng.params_from_variant_json(engine_json(PORT_EXAMPLES, NAME)) \
        .algorithm_params_list[0][1]
    assert params.num_iterations == 12
    assert params.weight_constraint_id == "weightedItems"
    assert params.unseen_only is False


def test_live_weights_shift_ranking(example_engine):
    storage, instance_id, algos, _ = _trained(example_engine)
    assert isinstance(algos[0], example_engine.WeightedECommAlgorithm)
    assert algos[0]._ctx is not None, "load_model must receive the serving instances"
    event_srv = EventServer(storage, EventServerConfig(ip="127.0.0.1", port=0)).start()

    def publish(groups) -> None:
        req = urllib.request.Request(
            f"http://127.0.0.1:{event_srv.port}/events.json?accessKey={KEY}",
            data=json.dumps({"event": "$set", "entityType": "constraint",
                             "entityId": "weightedItems",
                             "properties": {"weights": groups}}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 201

    try:
        with engine_server(storage, instance_id) as post:
            def query(user="u1", num=6):
                return post({"user": user, "num": num})["itemScores"]

            base = query()
            assert len(base) >= 3
            target, leader = base[2]["item"], base[0]["item"]
            base_scores = {s["item"]: s["score"] for s in base}
            # promote the target 5x and demote the current leader, live
            publish([{"items": [target], "weight": 5.0}, {"items": [leader], "weight": 0.1}])
            weighted = query()
            w_scores = {s["item"]: s["score"] for s in weighted}
            assert weighted[0]["item"] == target
            assert w_scores[target] == pytest.approx(5.0 * base_scores[target], rel=1e-4)
            assert w_scores.get(leader, 0.0) <= 0.1 * base_scores[leader] + 1e-6
            # weights replace (not merge): a neutral set restores
            publish([])
            assert {s["item"]: pytest.approx(s["score"], rel=1e-4)
                    for s in query()} == base_scores
    finally:
        event_srv.stop()


def test_malformed_weight_group_is_skipped_not_fatal(example_engine):
    """A negative, non-numeric or non-dict group is logged and skipped;
    valid groups in the same event still apply."""
    storage, _, algos, models = _trained(example_engine)
    algo, model = algos[0], models[0]
    base = algo.predict(model, Query(user="u1", num=4))
    assert base.item_scores
    target = base.item_scores[-1].item
    _insert(storage, _weights([
        {"items": ["i0"], "weight": -3.0},       # invalid: skipped
        {"items": ["i1"], "weight": "heavy"},    # invalid: skipped
        {"items": ["i2"], "weight": "nan"},      # invalid: skipped
        "oops",                                  # non-dict: skipped
        {"items": [target], "weight": 50.0},     # valid: applies
    ]))
    boosted = algo.predict(model, Query(user="u1", num=4))
    assert boosted.item_scores, "serving must survive malformed weights"
    assert boosted.item_scores[0].item == target


def test_weighted_copy_keeps_the_base_models_fields(example_engine):
    storage, _, algos, models = _trained(example_engine)
    algo, model = algos[0], models[0]
    algo.predict(model, Query(user="u1", num=4))        # builds the device allow vector
    _insert(storage, _weights([{"items": ["i3"], "weight": 2.0}]))
    weighted = algo._weighted_model(model).als
    assert weighted is not model.als
    assert weighted._default_allow is model.als._default_allow
    assert weighted.ann_index is model.als.ann_index and weighted.online_overlay is None
    assert weighted.item_factors.device == model.als.device
    want = model.als.item_factors.clone()
    want[model.als.item_ids["i3"]] *= 2.0
    torch.testing.assert_close(weighted.item_factors, want)
    assert algo._weighted_model(model).als is weighted   # cached per version


def test_engine_json_equals_jax():
    assert_same_variant(NAME)


def test_answers_equal_jax(example_engine, monkeypatch):
    jmod = jax_engine(NAME)
    train_exactly(monkeypatch)
    port_storage, jax_storage = twin_stores(APP, view_events())
    (palgos, pmodels, _), (jalgos, jmodels) = train_both(
        example_engine, jmod, _variant(), port_storage, jax_storage, JaxEngineContext)
    assert_factors_close(pmodels[0].als, jmodels[0].als)
    carried = ECommModel(als=port_als(jmodels[0].als), categories=jmodels[0].categories)

    def both(k: int, **fields) -> None:
        """The same event into both live stores."""
        fields = dict(fields, event_id=f"live-{k}",
                      event_time=datetime(2030, 1, 1, 0, 0, k, tzinfo=timezone.utc))
        props = fields.pop("properties", {})
        port_storage.get_events().insert(
            Event(**fields, properties=DataMap(props)),
            port_storage.get_meta_data_apps().get_by_name(APP).id)
        jax_storage.get_events().insert(
            JaxEvent(**fields, properties=JaxDataMap(props)),
            jax_storage.get_meta_data_apps().get_by_name(APP).id)

    def same(queries) -> None:
        for kw in queries:
            assert_same_scores(palgos[0].predict(carried, Query(**kw)),
                               jalgos[0].predict(jmodels[0], JaxQuery(**kw)))

    queries = [dict(user="u1", num=6), dict(user="u2", num=16), dict(user="ghost", num=4),
               dict(user="u5", num=5, black_list=("i3",))]
    for k, i in enumerate((2, 4)):
        both(k, event="view", entity_type="user", entity_id="ghost",
             target_entity_type="item", target_entity_id=f"i{i}")
    same(queries)
    both(2, event="$set", entity_type="constraint", entity_id="weightedItems",
         properties={"weights": [{"items": ["i3", "i9"], "weight": 3.0},
                                 {"items": ["i1"], "weight": 0.2},
                                 {"items": ["i0"], "weight": -1.0}, "oops"]})
    same(queries)
