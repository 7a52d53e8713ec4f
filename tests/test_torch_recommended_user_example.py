"""The port's ``examples_torch/similarproduct-recommended-user`` on the
CPU: the similar-product machinery on a social graph, entity types as
configuration.

- the JAX example's scenario (``tests/test_recommended_user_example.py``)
  replayed on the port with the same events and assertions, through
  ``run_train`` and the engine server over HTTP;
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

from predictionio_tpu.workflow.context import EngineContext as JaxEngineContext
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.templates.similarproduct import SimilarModel
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

NAME = "similarproduct-recommended-user"
APP = "RecommendedUserApp"


@pytest.fixture
def example_engine():
    with port_engine(NAME) as engine:
        yield engine


def follow_events() -> list[Event]:
    """Two follow communities (even/odd users) with sparse cross-links."""
    rng = np.random.default_rng(13)
    out = []
    for u in range(24):
        for v in range(24):
            if u == v:
                continue
            if rng.random() < (0.7 if (u % 2) == (v % 2) else 0.02):
                out.append(Event(event="follow", entity_type="user", entity_id=f"u{u}",
                                 target_entity_type="user", target_entity_id=f"u{v}",
                                 properties=DataMap({})))
    return out


def _variant() -> dict:
    variant = engine_json(PORT_EXAMPLES, NAME)
    variant["algorithms"][0]["params"]["use_mesh"] = False
    return variant


def test_follow_graph_trains_and_recommends_same_community(example_engine):
    storage = port_store(APP, follow_events())
    outcome = run_train(variant=_variant(), ctx=cpu_ctx(storage))
    assert outcome.status == "COMPLETED"
    with engine_server(storage, outcome.instance_id) as post:
        recs = [s["item"] for s in post({"users": ["u2", "u4"], "num": 4})["itemScores"]]
        assert recs, "no recommended users"
        # query users are excluded from their own recommendations
        assert not {"u2", "u4"} & set(recs)
        # the even community dominates similar-to-even-users results
        even = sum(1 for u in recs if int(u[1:]) % 2 == 0)
        assert even >= len(recs) - 1, recs
        assert len(recs) == 4
        # whiteList narrows to the allowed set (reference query parity)
        wl = [s["item"] for s in post({"users": ["u2"], "num": 4,
                                       "whiteList": ["u6", "u8", "u3"]})["itemScores"]]
        assert set(wl) <= {"u6", "u8", "u3"}, wl


def test_engine_json_equals_jax():
    assert_same_variant(NAME)


def test_answers_equal_jax(example_engine, monkeypatch):
    jmod = jax_engine(NAME)
    train_exactly(monkeypatch)
    port_storage, jax_storage = twin_stores(APP, follow_events())
    (palgos, pmodels, _), (jalgos, jmodels) = train_both(
        example_engine, jmod, _variant(), port_storage, jax_storage, JaxEngineContext)
    assert_factors_close(pmodels[0].als, jmodels[0].als)
    carried = SimilarModel(als=port_als(jmodels[0].als), categories=jmodels[0].categories)
    for kw in (dict(users=("u2", "u4"), num=4), dict(users=("u1",), num=10),
               dict(users=("u2",), num=4, white_list=("u6", "u8", "u3")),
               dict(users=("u3",), num=6, black_list=("u5", "u7")), dict(users=(), num=3)):
        assert_same_scores(
            palgos[0].predict(carried, example_engine.RecommendedUserQuery(**kw)),
            jalgos[0].predict(jmodels[0], jmod.RecommendedUserQuery(**kw)))
