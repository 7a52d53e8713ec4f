"""The port's ``examples_torch/markov-nextpage`` on the CPU: time-ordered
view streams become page transitions; the port's e2 Markov chain
(``MarkovChain.train`` → ``markov_top_transitions`` on the context's
device) keeps each page's row-normalized top-N; queries return
next-page probabilities.

- the JAX example's scenarios (``tests/test_markov_nextpage_example.py``)
  replayed on the port with the same events and assertions;
- held against the JAX example on the same events (its streams and a
  seeded random walk over 40 pages): the transitions equal, the chain's
  transition indices equal and its probabilities within 1e-6
  (``tests/test_torch_e2.py``), every answer's pages equal and
  probabilities within 1e-6;
- its engine.json equal to the JAX example's.
"""

from __future__ import annotations

from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from predictionio_tpu.workflow.context import EngineContext as JaxEngineContext
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.workflow.train import run_train
from torch_examples import (  # noqa: F401  (example_model_dir: autouse)
    PORT_EXAMPLES,
    assert_same_variant,
    cpu_ctx,
    engine_json,
    example_model_dir,
    jax_engine,
    port_engine,
    port_store,
    twin_stores,
)

NAME = "markov-nextpage"
APP = "NextPageApp"
PROB_TOL = 1e-6
T0 = datetime(2024, 5, 1, tzinfo=timezone.utc)


@pytest.fixture
def example_engine():
    with port_engine(NAME) as engine:
        yield engine


def stream_events(streams: dict) -> list[Event]:
    return [Event(event="view", entity_type="user", entity_id=u, target_entity_type="page",
                  target_entity_id=page, properties=DataMap({}),
                  event_time=T0 + timedelta(minutes=k))
            for u, pages in streams.items() for k, page in enumerate(pages)]


#: the JAX test's streams: p1 -> p2 three times, p1 -> p3 once
STREAMS = {"u0": ["p1", "p2", "p1", "p3"], "u1": ["p1", "p2", "p4"],
           "u2": ["p2", "p4", "p1", "p2"]}


def walk_streams(seed: int = 3, users: int = 30, pages: int = 40, length: int = 25) -> dict:
    rng = np.random.default_rng(seed)
    return {f"w{u}": [f"p{int(p)}" for p in rng.integers(0, pages, size=length) % (
        1 + u % pages)] for u in range(users)}


def _parts(module, storage, ctx, top_n=3):
    algo = module.MarkovChainAlgorithm(module.MCParams(top_n=top_n))
    ds = module.PageViewDataSource(module.DSParams(app_name=APP))
    td = ds.read_training(ctx)
    return algo, td, algo.train(ctx, td)


def test_datasource_orders_streams_by_time(example_engine):
    storage = port_store(APP, stream_events(STREAMS))
    td = example_engine.PageViewDataSource(
        example_engine.DSParams(app_name=APP)).read_training(cpu_ctx(storage))
    assert td.transitions.count(("p1", "p2")) == 3
    assert td.transitions.count(("p1", "p3")) == 1
    assert td.transitions.count(("p2", "p4")) == 2


def test_trains_and_predicts_next_pages(example_engine):
    storage = port_store(APP, stream_events(STREAMS))
    algo, _, model = _parts(example_engine, storage, cpu_ctx(storage))
    # from p1: p1->p2 three times, p1->p3 once -> 0.75 / 0.25
    out = algo.predict(model, example_engine.Query(page="p1", num=3))
    pages = {s.page: s.prob for s in out.pages}
    assert set(pages) == {"p2", "p3"}
    assert pages["p2"] == pytest.approx(0.75)
    assert pages["p3"] == pytest.approx(0.25)
    probs = [s.prob for s in out.pages]
    assert probs == sorted(probs, reverse=True)   # ranked
    # num caps the result; an unseen page is empty, not an error
    assert len(algo.predict(model, example_engine.Query(page="p1", num=1)).pages) == 1
    assert algo.predict(model, example_engine.Query(page="nope")).pages == ()


def test_query_class_declared_for_wire_binding(example_engine):
    assert example_engine.MarkovChainAlgorithm.query_class is example_engine.Query


def test_full_train_workflow_from_variant(example_engine):
    storage = port_store(APP, stream_events(STREAMS))
    outcome = run_train(variant=engine_json(PORT_EXAMPLES, NAME), ctx=cpu_ctx(storage))
    assert outcome.status == "COMPLETED"


def test_engine_json_equals_jax():
    assert_same_variant(NAME)


@pytest.mark.parametrize("streams,top_n", [(STREAMS, 3), (walk_streams(), 10)],
                         ids=["jax-test-streams", "random-walk"])
def test_chain_equals_jax(example_engine, streams, top_n):
    jmod = jax_engine(NAME)
    port_storage, jax_storage = twin_stores(APP, stream_events(streams))
    palgo, ptd, pmodel = _parts(example_engine, port_storage, cpu_ctx(port_storage), top_n)
    jalgo, jtd, jmodel = _parts(jmod, jax_storage, JaxEngineContext(storage=jax_storage),
                                top_n)
    assert ptd.transitions == jtd.transitions
    assert pmodel.pages.to_dict() == jmodel.pages.to_dict()
    np.testing.assert_array_equal(pmodel.chain.transition_index,
                                  np.asarray(jmodel.chain.transition_index))
    np.testing.assert_allclose(pmodel.chain.transition_prob,
                               np.asarray(jmodel.chain.transition_prob), atol=PROB_TOL)
    for page in list(pmodel.pages.to_dict()) + ["nope"]:
        for num in (1, 3, top_n):
            got = palgo.predict(pmodel, example_engine.Query(page=page, num=num)).pages
            want = jalgo.predict(jmodel, jmod.Query(page=page, num=num)).pages
            assert [s.page for s in got] == [s.page for s in want]
            np.testing.assert_allclose([s.prob for s in got], [s.prob for s in want],
                                       atol=PROB_TOL)
