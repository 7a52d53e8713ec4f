"""The port's ``examples_torch/hello-similarity`` on the CPU, a DASE
engine written from scratch: word-set vectors, cosine neighbours by one
product on the model's device, the top-k with ``lax.top_k``'s tie rule.
The JAX example has no test of its own, so this file holds the port
directly against the JAX example module:

- the seed script's four docs and a seeded corpus of 60 docs over a
  12-word vocabulary (word-set cosines tie often) in both packages'
  stores: the vectors equal, every answer's neighbours in JAX's order
  (ties included: equal cosines in ascending row order) with scores within
  1e-6, for every doc and num 1, 2, 3, 5 and 100, an unknown doc and num
  0;
- ``run_train`` → ``load_models`` → the engine server: the vectors come
  back on the deploy's device and the HTTP answer equals JAX's;
- its engine.json equal to the JAX example's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from predictionio_tpu.workflow.context import EngineContext as JaxEngineContext
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.workflow.persistence import load_models
from predictionio_tpu_torch.workflow.train import run_train
from torch_examples import (  # noqa: F401  (example_model_dir: autouse)
    PORT_EXAMPLES,
    assert_same_variant,
    cpu_ctx,
    engine_json,
    engine_server,
    example_model_dir,
    jax_engine,
    port_engine,
    seed_events,
    twin_stores,
)

NAME = "hello-similarity"
APP = "HelloApp"
SCORE_TOL = 1e-6
WORDS = tuple(f"w{k}" for k in range(12))


@pytest.fixture
def example_engine():
    with port_engine(NAME) as engine:
        yield engine


def corpus_events(n: int = 60, seed: int = 4) -> list[Event]:
    rng = np.random.default_rng(seed)
    return [Event(event="$set", entity_type="doc", entity_id=f"d{k:02d}",
                  properties=DataMap({"words": sorted(rng.choice(
                      WORDS, size=int(rng.integers(1, 5)), replace=False).tolist())}))
            for k in range(n)]


def _trained(module, storage, ctx):
    ds = module.WordsDataSource(module.DSParams(app_name=APP, entity_type="doc"))
    algo = module.CosineAlgorithm(module.AlgoParams())
    return algo, algo.train(ctx, ds.read_training(ctx))


def test_engine_json_equals_jax():
    assert_same_variant(NAME)


@pytest.mark.parametrize("events", [seed_events(NAME), corpus_events()],
                         ids=["seed-script", "tied-corpus"])
def test_neighbours_equal_jax(example_engine, events):
    jmod = jax_engine(NAME)
    port_storage, jax_storage = twin_stores(APP, events)
    palgo, pmodel = _trained(example_engine, port_storage, cpu_ctx(port_storage))
    jalgo, jmodel = _trained(jmod, jax_storage, JaxEngineContext(storage=jax_storage))
    assert pmodel.entities == jmodel.entities
    assert pmodel.vectors.device.type == "cpu"
    np.testing.assert_array_equal(pmodel.vectors.numpy(), jmodel.vectors)
    ties = 0
    for entity in pmodel.entities + ["nope"]:
        for num in (0, 1, 2, 3, 5, 100):
            got = palgo.predict(pmodel, example_engine.Query(entity=entity, num=num)).neighbors
            want = jalgo.predict(jmodel, jmod.Query(entity=entity, num=num)).neighbors
            assert [n.entity for n in got] == [n.entity for n in want], (entity, num)
            np.testing.assert_allclose([n.score for n in got], [n.score for n in want],
                                       atol=SCORE_TOL)
            scores = [n.score for n in want]
            ties += sum(a == b for a, b in zip(scores, scores[1:]))
    if len(events) > 4:
        assert ties > 100, ties    # the corpus exercises the tie rule


def test_trained_instance_serves_from_the_deploy_device(example_engine):
    jmod = jax_engine(NAME)
    port_storage, jax_storage = twin_stores(APP, corpus_events())
    outcome = run_train(variant=engine_json(PORT_EXAMPLES, NAME), ctx=cpu_ctx(port_storage))
    assert outcome.status == "COMPLETED"
    model = load_models(port_storage, outcome.instance_id, torch.device("cpu"))[0]
    assert isinstance(model.vectors, torch.Tensor) and model.vectors.device.type == "cpu"
    jalgo, jmodel = _trained(jmod, jax_storage, JaxEngineContext(storage=jax_storage))
    want = jalgo.predict(jmodel, jmod.Query(entity="d07", num=5)).neighbors
    with engine_server(port_storage, outcome.instance_id) as post:
        got = post({"entity": "d07", "num": 5})["neighbors"]
    assert [n["entity"] for n in got] == [n.entity for n in want]
    np.testing.assert_allclose([n["score"] for n in got], [n.score for n in want],
                               atol=SCORE_TOL)
