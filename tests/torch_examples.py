"""Shared loaders for the example-engine tests (``tests/test_torch_*_example.py``):
the port's example engines under ``examples_torch/`` held against the JAX
package's under ``examples/`` on the CPU.

Both examples of a pair are modules named ``engine``. The port's is
imported as ``engine`` from ``sys.path`` (its pickled models record
``engine.<Class>``), with any stale ``engine`` module evicted first and
after; the JAX one is loaded from its file under a name of its own, so
the two live side by side in one process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import sys
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from predictionio_tpu.core.datamap import DataMap as JaxDataMap
from predictionio_tpu.core.event import Event as JaxEvent
from predictionio_tpu.storage.base import App as JaxApp
from predictionio_tpu.templates import ecommerce as jecom
from predictionio_tpu.templates import recommendation as jrec
from predictionio_tpu.templates import similarproduct as jsim
from predictionio_tpu.utils import checkpoint as jckpt
from predictionio_tpu.utils.testing import memory_storage as jax_memory_storage
from predictionio_tpu_torch.api.engine_server import create_engine_server
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.models.als import ALSModel
from predictionio_tpu_torch.storage.base import App
from predictionio_tpu_torch.storage.registry import memory_storage
from predictionio_tpu_torch.templates import recommendation as prec
from predictionio_tpu_torch.templates import similarproduct as psim
from predictionio_tpu_torch.workflow.context import EngineContext
from predictionio_tpu_torch.workflow.deploy import ServerConfig
from predictionio_tpu_torch.workflow.persistence import load_models

REPO = Path(__file__).resolve().parent.parent
JAX_EXAMPLES = REPO / "examples"
PORT_EXAMPLES = REPO / "examples_torch"

#: scores of the same factors on both sides: f32 products in another
#: summation order
SCORE_TOL = 1e-5
#: trained factor tables, the port started from JAX's draw: relative
#: Frobenius distance (bf16 normal-equation build in both, another
#: summation order; tests/test_torch_similarproduct.py)
FACTOR_RTOL = 1e-3
#: consecutive scores of one answer closer than this are a near-tie:
#: f32 in another summation order moves a score by a few ulps
TIE_TOL = 1e-6


@contextlib.contextmanager
def port_engine(name: str):
    """``examples_torch/<name>/engine.py`` imported as ``engine``."""
    path = str(PORT_EXAMPLES / name)
    sys.path.insert(0, path)
    sys.modules.pop("engine", None)
    try:
        yield importlib.import_module("engine")
    finally:
        sys.path.remove(path)
        sys.modules.pop("engine", None)


def jax_engine(name: str):
    """``examples/<name>/engine.py`` under a module name of its own
    (registered, so its pickles resolve)."""
    mod_name = "jax_example_" + name.replace("-", "_")
    if mod_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(mod_name, JAX_EXAMPLES / name / "engine.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = module
        spec.loader.exec_module(module)
    return sys.modules[mod_name]


def seed_events(name: str) -> list[Event]:
    """The events of ``examples_torch/<name>/seed_events.py``."""
    mod_name = "port_seed_" + name.replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name,
                                                  PORT_EXAMPLES / name / "seed_events.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.events()


def engine_json(root: Path, name: str) -> dict:
    with open(root / name / "engine.json") as f:
        return json.load(f)


def assert_same_variant(name: str) -> None:
    """The port's engine.json equals the JAX example's as parsed JSON."""
    assert engine_json(PORT_EXAMPLES, name) == engine_json(JAX_EXAMPLES, name)


def numbered(events) -> list[Event]:
    """Events with ids ``e000000``... where they have none, so both
    packages' stores read them back in one order (time, then id)."""
    return [e if e.event_id else dataclasses.replace(e, event_id=f"e{k:06d}")
            for k, e in enumerate(events)]


def to_jax(e: Event) -> JaxEvent:
    return JaxEvent(event=e.event, entity_type=e.entity_type, entity_id=e.entity_id,
                    target_entity_type=e.target_entity_type,
                    target_entity_id=e.target_entity_id,
                    properties=JaxDataMap(e.properties.to_json()), event_time=e.event_time,
                    tags=e.tags, pr_id=e.pr_id, creation_time=e.creation_time,
                    event_id=e.event_id)


def port_store(app_name: str, events, storage=None):
    """``events`` into a fresh (or the given) port memory store's new app
    ``app_name``; the storage."""
    storage = storage or memory_storage()
    app_id = storage.get_meta_data_apps().insert(App(0, app_name))
    store = storage.get_events()
    store.init(app_id)
    store.insert_batch(list(events), app_id)
    return storage


def twin_stores(app_name: str, events) -> tuple:
    """The same events, numbered, in a port and a JAX memory store:
    (port storage, JAX storage)."""
    events = numbered(events)
    jax_storage = jax_memory_storage()
    app_id = jax_storage.get_meta_data_apps().insert(JaxApp(0, app_name))
    store = jax_storage.get_events()
    store.init(app_id)
    store.insert_batch([to_jax(e) for e in events], app_id)
    return port_store(app_name, events), jax_storage


def cpu_ctx(storage) -> EngineContext:
    return EngineContext(storage=storage, device="cpu")


def jax_item0(seed: int, num_items: int, rank: int) -> np.ndarray:
    """JAX's initial item factors for ``seed`` (its PRNGKey draw)."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (num_items, rank),
                                        dtype=jnp.float32) / jnp.sqrt(jnp.float32(rank)))


def train_exactly(monkeypatch, *example_modules) -> None:
    """Every ``als_train`` both packages' ALS templates reach (and
    ``example_modules``', examples that call it themselves) builds its
    normal equations in f32 and solves them exactly (Cholesky), and the
    port's starts from JAX's initial draw.

    The examples' small two-cluster data leave factor tables of rank 6-10
    ill-determined: the tables' own condition numbers, or those of the
    item-side normal equations, run into the thousands and beyond. There
    the default bf16 build and the fixed ``min(K + 4, 16)`` CG steps,
    rounding differently in each package, move the two packages' tables
    further apart than FACTOR_RTOL, although the two packages' CG solves
    agree on the same systems (tests/test_torch_als.py,
    ``test_cg_equals_jax``). With
    f32 normal equations and exact solves the two packages agree within
    FACTOR_RTOL; chip_smoke.py phase 31 logs how far the shipped
    configuration, trained on the card and on the CPU, drifts apart."""
    for module in (prec, psim, jrec, jsim, jecom, *example_modules):
        real = module.als_train
        port = real.__module__.startswith("predictionio_tpu_torch.")

        def exact(coo, *, rank, seed, _real=real, _port=port, **kw):
            kw.update(matmul_dtype="float32", solver="cholesky")
            if _port:
                kw["item0"] = jax_item0(seed, coo.num_cols, rank)
            return _real(coo, rank=rank, seed=seed, **kw)

        monkeypatch.setattr(module, "als_train", exact)


@pytest.fixture(autouse=True)
def example_model_dir(tmp_path, monkeypatch):
    """Checkpoints under the test's own directory; JAX's save takes its
    npz backend (its orbax default needs JAX to read). Autouse in every
    module that imports it."""
    monkeypatch.setenv("PIO_MODEL_DIR", str(tmp_path / "models"))
    monkeypatch.setattr(jckpt, "_ocp", lambda: None)


def components(module, variant: dict):
    """(data source, preparator, algorithms, serving) of ``module``'s
    engine bound to ``variant``."""
    engine = module.engine_factory()
    return engine.make_components(engine.params_from_variant_json(variant))


def train_both(port_mod, jax_mod, variant: dict, port_storage, jax_storage,
               jax_ctx_cls) -> tuple:
    """Each example's own components read, prepare and train on its
    store: ((port algorithms, port models, port prepared data),
    (JAX algorithms, JAX models))."""
    out = []
    for module, storage, ctx in ((port_mod, port_storage, cpu_ctx(port_storage)),
                                 (jax_mod, jax_storage, jax_ctx_cls(storage=jax_storage))):
        ds, prep, algos, _ = components(module, variant)
        pd = prep.prepare(ctx, ds.read_training(ctx))
        out.append((algos, [a.train(ctx, pd) for a in algos], pd))
    return out[0], out[1][:2]


def port_als(jmodel) -> ALSModel:
    """JAX's trained ALSModel carried to the port on the CPU."""
    return ALSModel.from_jax(np.asarray(jmodel.user_factors), np.asarray(jmodel.item_factors),
                             jmodel.user_ids.id_to_ix.to_dict(),
                             jmodel.item_ids.id_to_ix.to_dict(), jmodel.seen_by_user,
                             device="cpu")


def assert_factors_close(port_als_model: ALSModel, jax_als_model) -> None:
    """Both tables within FACTOR_RTOL relative Frobenius distance, rows
    matched by id."""
    for side in ("item", "user"):
        ids = getattr(port_als_model, f"{side}_ids")
        jids = getattr(jax_als_model, f"{side}_ids")
        order = [jids[ids.inverse[ix]] for ix in range(len(ids))]
        want = np.asarray(getattr(jax_als_model, f"{side}_factors"))[order]
        got = getattr(port_als_model, f"{side}_factors").cpu().numpy()
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < FACTOR_RTOL, side


def assert_same_scores(got, want, tol: float = SCORE_TOL) -> None:
    """Two answers' ``item_scores``: as many items, each score within
    ``tol`` of JAX's for the same item, and the ids in JAX's order but
    within a near-tie — consecutive JAX scores closer than TIE_TOL (two
    items the same users rated, which f32 in another summation order
    cannot order) — whose items compare as a set."""
    g = [(s.item, s.score) for s in got.item_scores]
    w = [(s.item, s.score) for s in want.item_scores]
    assert len(g) == len(w), (g, w)
    start = 0
    for end in range(1, len(w) + 1):
        if end == len(w) or abs(w[end][1] - w[end - 1][1]) > TIE_TOL:
            assert {i for i, _ in g[start:end]} == {i for i, _ in w[start:end]}, (g, w)
            start = end
    want_score = dict(w)
    np.testing.assert_allclose([s for _, s in g], [want_score[i] for i, _ in g],
                               rtol=tol, atol=tol)


@contextlib.contextmanager
def engine_server(storage, instance_id: str):
    """The engine instance behind the port's engine server on the CPU
    (``create_engine_server``, the deploy wiring): yields ``post(body)``,
    which answers the parsed JSON of ``POST /queries.json``."""
    server = create_engine_server(storage, ServerConfig(
        ip="127.0.0.1", port=0, device="cpu", engine_instance_id=instance_id)).start()

    def post(body: dict) -> dict:
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/queries.json",
                                     data=json.dumps(body).encode(), method="POST",
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read())

    try:
        yield post
    finally:
        server.stop()


def deployed(module, variant: dict, storage, instance_id: str) -> tuple:
    """(algorithms, serving, models) of a trained instance, loaded as a
    deploy loads it: one set of algorithm instances loads and serves."""
    engine = module.engine_factory()
    ep = engine.params_from_variant_json(variant)
    _, _, algos, serving = engine.make_components(ep)
    models = engine.prepare_deploy(cpu_ctx(storage), ep,
                                   load_models(storage, instance_id, "cpu"), algorithms=algos)
    return algos, serving, models
