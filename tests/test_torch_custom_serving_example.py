"""The port's ``examples_torch/recommendation-custom-serving`` on the CPU:
a Serving with its own params drops disabled items at serve time,
re-reading the file on every query.

- the JAX example's scenarios (``tests/test_custom_serving_example.py``)
  replayed on the port with the same events and assertions;
- held against the JAX example on the same events: the ALS factors (both
  packages' normal equations in f32 and solved exactly, the port from
  JAX's initial draw; ``torch_examples.train_exactly`` says why) within a
  relative Frobenius distance of 1e-3; the port serving JAX's trained
  factors through both examples' Serving, with and without a disabled
  item, ids and order equal (a near-tie, JAX scores within 1e-6, compares
  as a set) and scores within 1e-5;
- its engine.json equal to the JAX example's;
- the shipped configuration's trained scores move past 1e-3 when the
  initial item table changes by 1e-6, which is why the card's training
  is not held to the CPU's (chip_smoke.py phase 31);
- the README walk-through as `python -m predictionio_tpu_torch.cli.pio ...
  --device cpu` processes: `app new`, `seed_events.py`, `build`, `train`,
  `deploy`, a query, a live edit of ``disabled.txt`` and the same query
  again, which lacks the disabled item with no redeploy.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.templates.recommendation import Query as JaxQuery
from predictionio_tpu.workflow.context import EngineContext as JaxEngineContext
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.ops import als as pals
from predictionio_tpu_torch.templates import recommendation as prec
from predictionio_tpu_torch.templates.recommendation import Query
from predictionio_tpu_torch.workflow.persistence import load_models
from predictionio_tpu_torch.workflow.train import run_train
from torch_examples import (  # noqa: F401  (example_model_dir: autouse)
    PORT_EXAMPLES,
    REPO,
    assert_factors_close,
    assert_same_scores,
    assert_same_variant,
    components,
    cpu_ctx,
    engine_json,
    example_model_dir,
    jax_engine,
    numbered,
    port_als,
    port_engine,
    port_store,
    seed_events,
    train_both,
    train_exactly,
    twin_stores,
)

NAME = "recommendation-custom-serving"
APP = "CustomServingApp"


@pytest.fixture
def example_engine():
    with port_engine(NAME) as engine:
        yield engine


def rating_events() -> list[Event]:
    """The JAX test's store: two taste clusters of 5.0 ratings."""
    rng = np.random.default_rng(5)
    return [Event(event="rate", entity_type="user", entity_id=f"u{u}",
                  target_entity_type="item", target_entity_id=f"i{i}",
                  properties=DataMap({"rating": 5.0}))
            for u in range(16) for i in range(12)
            if i % 2 == u % 2 and rng.random() < 0.9]


def test_shipped_engine_json_binds(example_engine):
    """The shipped engine.json binds as-is (camelCase param names)."""
    with open(PORT_EXAMPLES / NAME / "engine.json") as f:
        variant = json.load(f)
    eng = example_engine.engine_factory()
    ep = eng.params_from_variant_json(variant)
    algo_params = ep.algorithm_params_list[0][1]
    assert algo_params.num_iterations == 10
    assert algo_params.lambda_ == 0.01
    assert ep.serving_params[1].filepath == "disabled.txt"


def test_serve_time_filtering_live(example_engine, tmp_path):
    disabled_file = tmp_path / "disabled.txt"
    variant = {
        "id": "custom-serving",
        "engineFactory": "engine.engine_factory",
        "datasource": {"params": {"app_name": APP}},
        "algorithms": [{"name": "als", "params": {"rank": 8, "num_iterations": 8,
                                                  "lambda_": 0.05, "seed": 1,
                                                  "use_mesh": False}}],
        "serving": {"params": {"filepath": str(disabled_file)}},
    }
    storage = port_store(APP, rating_events())
    outcome = run_train(variant=variant, ctx=cpu_ctx(storage))
    assert outcome.status == "COMPLETED"

    eng = example_engine.engine_factory()
    ep = eng.params_from_variant_json(variant)
    _, _, algos, serving = eng.make_components(ep)
    models = eng.prepare_deploy(cpu_ctx(storage), ep,
                                load_models(storage, outcome.instance_id, "cpu"),
                                algorithms=algos)
    assert isinstance(serving, example_engine.DisabledItemsServing)

    def ask(user="u0", num=5):
        q = serving.supplement(Query(user=user, num=num))
        return serving.serve(q, [a.predict(m, q) for a, m in zip(algos, models)])

    first = ask()
    assert len(first.item_scores) > 0
    target = first.item_scores[0].item
    # disable the top item; the next query (same deployed model) drops it
    disabled_file.write_text(f"{target}\n")
    filtered = ask()
    assert target not in [s.item for s in filtered.item_scores]
    assert len(filtered.item_scores) >= len(first.item_scores) - 1
    # live re-enable: clearing the file restores it without redeploy
    disabled_file.write_text("")
    assert target in [s.item for s in ask().item_scores]


def test_engine_json_equals_jax():
    assert_same_variant(NAME)


def test_answers_equal_jax(example_engine, tmp_path, monkeypatch):
    """Same events in both stores: the factors agree from JAX's draw,
    and the port serving JAX's factors answers as JAX does."""
    jmod = jax_engine(NAME)
    disabled_file = tmp_path / "disabled.txt"
    variant = {"datasource": {"params": {"app_name": APP}},
               "algorithms": [{"name": "als", "params": {
                   "rank": 6, "numIterations": 6, "lambda": 0.05, "seed": 2,
                   "use_mesh": False}}],
               "serving": {"params": {"filepath": str(disabled_file)}}}
    train_exactly(monkeypatch)
    port_storage, jax_storage = twin_stores(APP, rating_events())
    (palgos, pmodels, _), (jalgos, jmodels) = train_both(
        example_engine, jmod, variant, port_storage, jax_storage, JaxEngineContext)
    assert_factors_close(pmodels[0], jmodels[0])
    carried = port_als(jmodels[0])
    pserving = components(example_engine, variant)[3]
    jserving = components(jmod, variant)[3]
    for disabled in ("", "i2\ni4\n"):
        disabled_file.write_text(disabled)
        for user, num in (("u0", 5), ("u1", 6), ("u7", 12), ("nobody", 3)):
            got = pserving.serve(Query(user=user, num=num),
                                 [palgos[0].predict(carried, Query(user=user, num=num))])
            want = jserving.serve(JaxQuery(user=user, num=num),
                                  [jalgos[0].predict(jmodels[0], JaxQuery(user=user, num=num))])
            assert_same_scores(got, want)


def test_shipped_training_is_not_determined_to_1e_3(example_engine, monkeypatch):
    """Why chip_smoke.py phase 31 holds an ALS example trained on the card
    to the same model served on the CPU, not to the one trained on the
    CPU: with the shipped engine.json (rank 10, 10 iterations, λ 0.01,
    bf16 normal equations, CG) on the seed script's events, an initial
    item table changed by 1e-6 (relative) moves the answers' scores by
    more than 1e-3, on the CPU alone."""
    real = pals.als_train

    def start(scale):
        def train(coo, *, rank, seed, **kw):
            item0 = pals.init_item_factors(coo.num_cols, rank, seed).numpy()
            noise = np.random.default_rng(1).standard_normal(item0.shape)
            return real(coo, rank=rank, seed=seed,
                        item0=(item0 * (1 + scale * noise)).astype(np.float32), **kw)
        return train

    variant = engine_json(PORT_EXAMPLES, NAME)
    scores = []
    for scale in (0.0, 1e-6):
        monkeypatch.setattr(prec, "als_train", start(scale))
        storage = port_store(APP, numbered(seed_events(NAME)))
        ds, prep, algos, _ = components(example_engine, variant)
        ctx = cpu_ctx(storage)
        model = algos[0].train(ctx, prep.prepare(ctx, ds.read_training(ctx)))
        scores.append(np.concatenate([
            [s.score for s in algos[0].predict(model, Query(user=f"u{u}", num=12)).item_scores]
            for u in range(16)]))
    assert scores[0].shape == scores[1].shape
    assert np.abs(scores[0] - scores[1]).max() > 1e-3


def _pio(env, cwd, *args, timeout=180) -> str:
    p = subprocess.run([sys.executable, "-m", "predictionio_tpu_torch.cli.pio", *args],
                       cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)
    assert p.returncode == 0, p.stdout + p.stderr
    return p.stdout


def _query(port: int, body: dict) -> list[str]:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/queries.json",
                                 data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return [s["item"] for s in json.loads(resp.read())["itemScores"]]


def test_readme_walkthrough_through_pio_processes(tmp_path):
    """README.md's steps from a copy of the example's directory."""
    work = tmp_path / NAME
    shutil.copytree(PORT_EXAMPLES / NAME, work,
                    ignore=shutil.ignore_patterns("__pycache__", "disabled.txt"))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_") and k != "PIO_MODEL_DIR"}
    env.update(PIO_FS_BASEDIR=str(tmp_path / "store"),
               PYTHONPATH=os.pathsep.join([str(REPO)] + [p for p in
                                                          [env.get("PYTHONPATH")] if p]))
    _pio(env, work, "app", "new", APP)
    seeded = subprocess.run([sys.executable, "seed_events.py"], cwd=work, env=env,
                            capture_output=True, text=True, timeout=120)
    assert seeded.returncode == 0 and "seeded" in seeded.stdout, seeded.stdout + seeded.stderr
    assert "Build successful" in _pio(env, work, "build")
    out = _pio(env, work, "train", "--device", "cpu")
    iid = re.search(r"engine instance (\w+) \(COMPLETED\)", out).group(1)

    log = open(tmp_path / "deploy.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.pio", "deploy", "--ip",
         "127.0.0.1", "--port", "0", "--device", "cpu"],
        cwd=work, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 180
        while not (found := re.search(r"Engine instance (\w+) listening on 127\.0\.0\.1:(\d+)",
                                      (tmp_path / "deploy.log").read_text())):
            assert proc.poll() is None and time.monotonic() < deadline, \
                (tmp_path / "deploy.log").read_text()
            time.sleep(0.1)
        assert found.group(1) == iid
        port = int(found.group(2))
        body = {"user": "u1", "num": 4}
        first = _query(port, body)
        assert len(first) == 4, first
        (work / "disabled.txt").write_text(f"{first[0]}\n")   # live, no redeploy
        after = _query(port, body)
        assert after == first[1:], (first, after)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        log.close()
