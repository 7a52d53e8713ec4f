"""The port's ``examples_torch/similarproduct-multi-events-multi-algos``
on the CPU: two event streams (view + like/dislike with latest-wins
dedup), two algorithms (view ALS + ``LikeAlgorithm``, which calls
``als_train`` itself on the context's device) and a z-score
standardizing Serving.

- the JAX example's scenarios (``tests/test_multi_events_example.py``)
  replayed on the port with the same events and assertions, through
  ``run_train``, the deploy wiring and the engine server over HTTP;
- held against the JAX example on the same events: the deduplicated like
  triples equal; both algorithms' ALS factors (both packages' normal
  equations in f32 and solved exactly, the port from JAX's initial draw,
  the example module's own ``als_train`` patched too;
  ``torch_examples.train_exactly`` says why) within a relative Frobenius
  distance of 1e-3; the port serving JAX's trained factors through both
  algorithms and the blend, ids and order equal (a near-tie, JAX scores
  within 1e-6, compares as a set) and scores within 1e-5;
- its engine.json equal to the JAX example's.
"""

from __future__ import annotations

from datetime import datetime, timedelta, timezone

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

NAME = "similarproduct-multi-events-multi-algos"
APP = "MultiSimilarApp"


@pytest.fixture
def example_engine():
    with port_engine(NAME) as engine:
        yield engine


def multi_events() -> list[Event]:
    """The JAX test's store: two view-taste clusters over 32 users; every
    even user dislikes item 0; u2 likes then dislikes it (latest wins);
    every event has its own, increasing timestamp."""
    rng = np.random.default_rng(11)
    t0 = datetime.now(timezone.utc)
    seq = iter(range(10_000_000))
    out = []

    def emit(event, u, i, minutes=0):
        out.append(Event(event=event, entity_type="user", entity_id=f"u{u}",
                         target_entity_type="item", target_entity_id=f"i{i}",
                         properties=DataMap({}),
                         event_time=t0 + timedelta(minutes=minutes, milliseconds=next(seq))))

    for u in range(32):
        for i in range(16):
            if i % 2 == u % 2 and rng.random() < 0.85:
                emit("view", u, i)
            if i % 2 == u % 2 and i != 0 and rng.random() < 0.5:
                emit("like", u, i)
    for u in range(0, 32, 2):
        emit("dislike", u, 0, minutes=5)
    emit("like", 2, 0, minutes=6)
    emit("dislike", 2, 0, minutes=7)
    return out


def _variant() -> dict:
    variant = engine_json(PORT_EXAMPLES, NAME)
    for algo in variant["algorithms"]:
        algo["params"]["use_mesh"] = False
    return variant


def test_shipped_engine_json_binds_two_algorithms(example_engine):
    eng = example_engine.engine_factory()
    ep = eng.params_from_variant_json(_variant())
    assert [name for name, _ in ep.algorithm_params_list] == ["als", "likealgo"]
    assert ep.algorithm_params_list[0][1].num_iterations == 12
    assert ep.algorithm_params_list[1][1].alpha == 5.0


def test_latest_event_wins_dedup(example_engine):
    storage = port_store(APP, multi_events())
    ds = example_engine.MultiDataSource(example_engine.MultiDataSourceParams(app_name=APP))
    td = ds.read_training(cpu_ctx(storage))
    by_pair = dict(zip(zip(td.like_users, td.like_items), td.like_signs))
    # u2 liked i0 at t+6 then disliked at t+7: the dislike stands
    assert by_pair[("u2", "i0")] == -1.0
    assert (td.like_signs == -1.0).sum() >= 10


def test_blend_demotes_disliked_item_and_serves_http(example_engine):
    storage = port_store(APP, multi_events())
    outcome = run_train(variant=_variant(), ctx=cpu_ctx(storage))
    assert outcome.status == "COMPLETED"
    algos, serving, models = deployed(example_engine, _variant(), storage, outcome.instance_id)
    assert len(models) == 2
    assert isinstance(serving, example_engine.StandardizeServing)

    # item 0 is in the even-view cluster, so the view-only algorithm
    # ranks it among items similar to i2...
    q = Query(items=("i2",), num=6)
    view_items = [s.item for s in algos[0].predict(models[0], q).item_scores]
    assert "i0" in view_items
    # ...but every even user dislikes it, so the blend ranks it lower
    blended = serving.serve(q, [a.predict(m, q) for a, m in zip(algos, models)])
    blend_items = [s.item for s in blended.item_scores]
    assert len(blend_items) > 0
    v_pos = view_items.index("i0")
    b_pos = blend_items.index("i0") if "i0" in blend_items else len(blend_items)
    assert b_pos > v_pos, (view_items, blend_items)
    # the same instance behind the engine server
    with engine_server(storage, outcome.instance_id) as post:
        body = post({"items": ["i2"], "num": 6})
    assert [s["item"] for s in body["itemScores"]] == blend_items


def test_engine_json_equals_jax():
    assert_same_variant(NAME)


def test_answers_equal_jax(example_engine, monkeypatch):
    jmod = jax_engine(NAME)
    train_exactly(monkeypatch, example_engine, jmod)
    port_storage, jax_storage = twin_stores(APP, multi_events())
    (palgos, pmodels, ppd), (jalgos, jmodels) = train_both(
        example_engine, jmod, _variant(), port_storage, jax_storage, JaxEngineContext)
    ptd = example_engine.MultiDataSource(
        example_engine.MultiDataSourceParams(app_name=APP)).read_training(cpu_ctx(port_storage))
    jtd = jmod.MultiDataSource(jmod.MultiDataSourceParams(app_name=APP)).read_training(
        JaxEngineContext(storage=jax_storage))
    assert list(zip(ptd.like_users, ptd.like_items, ptd.like_signs)) == \
        list(zip(jtd.like_users, jtd.like_items, jtd.like_signs))
    assert ppd.likes.user_ids.id_to_ix.to_dict() == jmodels[1].als.user_ids.id_to_ix.to_dict()
    for pm, jm in zip(pmodels, jmodels):
        assert_factors_close(pm.als, jm.als)
    carried = [SimilarModel(als=port_als(jm.als), categories=jm.categories) for jm in jmodels]
    pserving = example_engine.StandardizeServing()
    jserving = jmod.StandardizeServing()
    for kw in (dict(items=("i2",), num=6), dict(items=("i1", "i3"), num=8),
               dict(items=("i4",), num=1), dict(items=("i0",), num=12)):
        pp = [a.predict(m, Query(**kw)) for a, m in zip(palgos, carried)]
        jp = [a.predict(m, JaxQuery(**kw)) for a, m in zip(jalgos, jmodels)]
        for got, want in zip(pp, jp):
            assert_same_scores(got, want)
        assert_same_scores(pserving.serve(Query(**kw), pp), jserving.serve(JaxQuery(**kw), jp))
