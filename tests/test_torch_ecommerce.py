"""The port's e-commerce template (``templates/ecommerce.py``) against
the JAX package's on the CPU: the same view and buy events in both
packages' memory stores read to the same training data and train to the
same factors (the port from JAX's initial draw); the port serving JAX's
trained factors answers every query as JAX does, ids and order, with
the live reads of ``unavailableItems`` and of recent views changed after
training in both stores. Also batch_predict against predict, a
save/load round trip with ``categories.json`` equal to JAX's, and the
deployed engine over HTTP seeing a constraint posted after deploy.
"""

from __future__ import annotations

import dataclasses
import json
import urllib.request
from datetime import timedelta

import numpy as np
import pytest

from predictionio_tpu.core.datamap import DataMap as JaxDataMap
from predictionio_tpu.core.event import Event as JaxEvent
from predictionio_tpu.storage.base import App as JaxApp
from predictionio_tpu.templates import ecommerce as jecom
from predictionio_tpu.utils.testing import memory_storage as jax_memory_storage
from predictionio_tpu.workflow.context import EngineContext as JaxEngineContext
from predictionio_tpu.workflow.context import WorkflowParams as JaxWorkflowParams
from predictionio_tpu_torch.api.engine_server import create_engine_server
from predictionio_tpu_torch.controller import ShardedAlgorithm
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.storage.base import App
from predictionio_tpu_torch.storage.registry import memory_storage
from predictionio_tpu_torch.templates import ecommerce as pecom
from predictionio_tpu_torch.workflow.context import EngineContext, WorkflowParams
from predictionio_tpu_torch.workflow.deploy import ServerConfig
from predictionio_tpu_torch.workflow.train import run_train
from tests.test_torch_similarproduct import (
    APP,
    T0,
    _model_dir,  # noqa: F401  (autouse: checkpoints under tmp_path, JAX's npz backend)
    answers,
    assert_factors_close,
    assert_same_answer,
    ctx,
    fill,
    insert,
    port_from_jax,
    trained,
    view_events,
)

LATER = T0 + timedelta(days=1)


def shop_events(seed=1):
    """view_events plus buys (every 4th user buys two of its items) and
    a ``constraint`` ``$set`` that makes i3 and i4 unavailable."""
    out = view_events(seed)
    rng = np.random.default_rng(seed)
    n = len(out)
    for u in range(0, 30, 4):
        for i in rng.choice(40, 2, replace=False):
            out.append(dict(event="buy", entity_type="user", entity_id=f"u{u}",
                            target_entity_type="item", target_entity_id=f"i{i}", properties={},
                            event_time=T0 + timedelta(seconds=n), event_id=f"b{n:05d}"))
            n += 1
    out.append(dict(event="$set", entity_type="constraint", entity_id="unavailableItems",
                    target_entity_type=None, target_entity_id=None,
                    properties={"items": ["i3", "i4"]}, event_time=T0 + timedelta(seconds=n),
                    event_id="c0"))
    return out


def later_events():
    """After training: i0, i6 and i9 unavailable (a newer ``$set``), and
    a user the model never saw viewing three items."""
    out = [dict(event="$set", entity_type="constraint", entity_id="unavailableItems",
                target_entity_type=None, target_entity_id=None,
                properties={"items": ["i0", "i6", "i9"]}, event_time=LATER, event_id="c1")]
    for k, item in enumerate(("i1", "i2", "i7")):
        out.append(dict(event="view", entity_type="user", entity_id="newbie",
                        target_entity_type="item", target_entity_id=item, properties={},
                        event_time=LATER + timedelta(seconds=k + 1), event_id=f"n{k}"))
    return out


@pytest.fixture
def stores():
    events = shop_events()
    return (fill(memory_storage(), App, Event, DataMap, events),
            fill(jax_memory_storage(), JaxApp, JaxEvent, JaxDataMap, events))


def _trained(stores, monkeypatch, **changes):
    return trained(*stores, monkeypatch, pecom, jecom, "ecomm", app_name=APP, **changes)


QUERIES = [
    dict(user="u0", num=5),
    dict(user="u1", num=10),
    dict(user="u2", num=8, categories=("c1",)),
    dict(user="u3", num=40, categories=("c0", "c3")),
    dict(user="u5", num=5, categories=()),
    dict(user="u6", num=6, white_list=("i2", "i3", "i5", "i8", "i11", "i0", "nope")),
    dict(user="u7", num=6, white_list=()),
    dict(user="u8", num=10, black_list=("i9", "i12", "i15")),
    dict(user="u9", num=12, categories=("c2",), black_list=("i10",),
         white_list=tuple(f"i{i}" for i in range(0, 40, 2))),
    dict(user="newbie", num=5),
    dict(user="newbie", num=5, categories=("c1", "c2")),
    dict(user="ghost", num=5),
]


def _both_answers(palgo, pmodel, jalgo, jmodel, q):
    got = answers(palgo.predict(pmodel, pecom.Query(**q)))
    want = answers(jalgo.predict(jmodel, jecom.Query(**q)))
    assert_same_answer(got, want)
    return got


class TestTemplate:
    def test_training_data_equals_jax(self, stores):
        port_storage, jax_storage = stores
        got = pecom.ECommDataSource(pecom.DataSourceParams(app_name=APP)).read_training(
            ctx(port_storage))
        want = jecom.ECommDataSource(jecom.DataSourceParams(app_name=APP)).read_training(
            JaxEngineContext(storage=jax_storage))
        assert got.users.tolist() == want.users.tolist()
        assert got.items.tolist() == want.items.tolist()
        np.testing.assert_array_equal(got.weights, want.weights)
        assert got.weights.dtype == np.float32 and 4.0 in got.weights
        assert got.categories == want.categories

    def test_defaults_and_params_bind_as_jax(self):
        variant = {"datasource": {"params": {"appName": "A", "buyWeight": 2.0}},
                   "algorithms": [{"name": "ecomm", "params": {
                       "appName": "A", "unseenOnly": False, "recentEventsNum": 3,
                       "rank": 4, "lambda": 0.2, "useMesh": False}}]}
        got = pecom.engine_factory().params_from_variant_json(variant)
        want = jecom.engine_factory().params_from_variant_json(variant)
        assert [(n, dataclasses.asdict(p)) for n, p in got.algorithm_params_list] == \
            [(n, dataclasses.asdict(p)) for n, p in want.algorithm_params_list]
        assert dataclasses.asdict(got.data_source_params[1]) == \
            dataclasses.asdict(want.data_source_params[1])
        assert dataclasses.asdict(pecom.ECommAlgorithmParams()) == \
            dataclasses.asdict(jecom.ECommAlgorithmParams())
        assert issubclass(pecom.ECommAlgorithm, ShardedAlgorithm)

    def test_factors_equal_jax(self, stores, monkeypatch):
        _, pmodel, _, jmodel, _ = _trained(stores, monkeypatch)
        assert_factors_close(pmodel, jmodel)

    @pytest.mark.parametrize("unseen_only", [True, False])
    @pytest.mark.parametrize("q", QUERIES, ids=lambda q: json.dumps(q)[:60])
    def test_answers_equal_jax_before_and_after_live_changes(self, stores, monkeypatch, q,
                                                             unseen_only):
        """The query as trained (i3 and i4 unavailable; newbie unknown and
        without views), then again after a newer constraint and newbie's
        views land in both stores."""
        palgo, _, jalgo, jmodel, _ = _trained(stores, monkeypatch, unseen_only=unseen_only)
        pmodel = pecom.ECommModel(als=port_from_jax(jmodel.als), categories=jmodel.categories)
        empty = (q.get("categories") == () or q.get("white_list") == ()
                 or q["user"] == "ghost")
        before = _both_answers(palgo, pmodel, jalgo, jmodel, q)
        assert not {"i3", "i4"} & {i for i, _ in before}
        assert (before == []) == (empty or q["user"] == "newbie")
        insert(stores[0], Event, DataMap, APP, later_events())
        insert(stores[1], JaxEvent, JaxDataMap, APP, later_events())
        after = _both_answers(palgo, pmodel, jalgo, jmodel, q)
        assert not {"i0", "i6", "i9"} & {i for i, _ in after}
        assert (after == []) == empty
        if q["user"] == "newbie":   # similar to its views, never one of them
            assert not {"i1", "i2", "i7"} & {i for i, _ in after}
        seen = jmodel.als.seen_by_user.get(jmodel.als.user_ids.get(q["user"]), ())
        if unseen_only and len(seen):
            assert not {jmodel.als.item_ids.inverse[int(i)] for i in seen} & {
                i for i, _ in after}

    def test_unrestricted_allow_vector_stays_none(self, stores, monkeypatch):
        """No rule and no unavailable item: None (the fast default path),
        as in JAX; an unavailable item makes a 0/1 vector."""
        palgo, pmodel, jalgo, jmodel, _ = _trained(stores, monkeypatch)
        empty = [dict(event="$set", entity_type="constraint", entity_id="unavailableItems",
                      target_entity_type=None, target_entity_id=None, properties={"items": []},
                      event_time=LATER, event_id="c2")]
        assert palgo._allow_vector(pmodel, pecom.Query(user="u1")) is not None
        insert(stores[0], Event, DataMap, APP, empty)
        insert(stores[1], JaxEvent, JaxDataMap, APP, empty)
        assert palgo._allow_vector(pmodel, pecom.Query(user="u1")) is None
        assert jalgo._allow_vector(jmodel, jecom.Query(user="u1")) is None

    def test_batch_predict_equals_predict(self, stores, monkeypatch):
        palgo, pmodel, *_ = _trained(stores, monkeypatch)
        queries = [(k, pecom.Query(**q)) for k, q in enumerate(QUERIES)]
        batched = palgo.batch_predict(pmodel, queries)
        assert [k for k, _ in batched] == list(range(len(QUERIES)))
        for (_, q), (_, got) in zip(queries, batched):
            assert got == palgo.predict(pmodel, q)

    def test_save_load_round_trip_and_categories_json(self, stores, monkeypatch, tmp_path):
        palgo, pmodel, jalgo, jmodel, _ = _trained(stores, monkeypatch)
        pctx = EngineContext(WorkflowParams(engine_instance_id="run1"), stores[0], "cpu")
        manifest = palgo.make_persistent_model(pctx, pmodel)
        jmanifest = jalgo.make_persistent_model(
            JaxEngineContext(workflow_params=JaxWorkflowParams(engine_instance_id="run2"),
                             storage=stores[1]), jmodel)
        assert manifest.location == str(tmp_path / "ecomm_run1_a0")
        read = lambda loc: (tmp_path / loc / "categories.json").read_text()
        assert read(manifest.location) == read(jmanifest.location)
        fresh = pecom.ECommAlgorithm(palgo.params)
        back = fresh.load_model(pctx, manifest)
        assert fresh._ctx is pctx and back.categories == pmodel.categories
        for q in QUERIES:
            assert fresh.predict(back, pecom.Query(**q)) == palgo.predict(pmodel,
                                                                          pecom.Query(**q))

    def test_deployed_engine_reads_the_store_live(self, stores, tmp_path):
        """run_train → the engine server over the port's store; a newer
        ``unavailableItems`` and newbie's views, written after deploy,
        show in the next HTTP answers."""
        port_storage, _ = stores
        variant = {"engineFactory": "predictionio_tpu_torch.templates.ecommerce.engine_factory",
                   "datasource": {"params": {"appName": APP}},
                   "algorithms": [{"name": "ecomm", "params": {
                       "appName": APP, "rank": 6, "numIterations": 5, "seed": 5}}]}
        outcome = run_train(variant=variant, ctx=ctx(port_storage))
        assert outcome.status == "COMPLETED"
        server = create_engine_server(port_storage, ServerConfig(
            ip="127.0.0.1", port=0, device="cpu")).start()

        def post(body):
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/queries.json", data=json.dumps(body).encode(),
                method="POST", headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                return [s["item"] for s in json.loads(resp.read())["itemScores"]]

        try:
            first = post({"user": "u0", "num": 40})
            assert first and not {"i3", "i4"} & set(first)
            assert post({"user": "newbie", "num": 5}) == []
            insert(port_storage, Event, DataMap, APP, later_events())
            after = post({"user": "u0", "num": 40})
            assert not {"i0", "i6", "i9"} & set(after) and {"i3", "i4"} & set(after)
            assert post({"user": "newbie", "num": 5})
        finally:
            server.stop()
