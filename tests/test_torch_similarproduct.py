"""The port's similar-product template (``templates/similarproduct.py``)
against the JAX package's on the CPU: the same events in both packages'
memory stores read to the same training data, train to the same factor
tables (the port started from JAX's initial draw), and — the port
serving JAX's trained factors — answer every query with the same items
in the same order. Also: batch_predict against predict, a save/load
round trip, each package loading the other's saved model, and
``categories.json`` equal to JAX's.
"""

from __future__ import annotations

import dataclasses
import json
from datetime import datetime, timedelta, timezone

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from predictionio_tpu.core.datamap import DataMap as JaxDataMap
from predictionio_tpu.core.event import Event as JaxEvent
from predictionio_tpu.storage.base import App as JaxApp
from predictionio_tpu.templates import similarproduct as jsim
from predictionio_tpu.utils import checkpoint as jckpt
from predictionio_tpu.utils.testing import memory_storage as jax_memory_storage
from predictionio_tpu.workflow.context import EngineContext as JaxEngineContext
from predictionio_tpu.workflow.context import WorkflowParams as JaxWorkflowParams
from predictionio_tpu_torch.controller import ShardedAlgorithm
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.models.als import ALSModel
from predictionio_tpu_torch.storage.base import App
from predictionio_tpu_torch.storage.registry import memory_storage
from predictionio_tpu_torch.templates import similarproduct as psim
from predictionio_tpu_torch.workflow.context import EngineContext, WorkflowParams

T0 = datetime(2026, 2, 1, tzinfo=timezone.utc)
APP = "ShopApp"
#: scores of the same factors on both sides: f32 products in another
#: summation order
SCORE_TOL = 1e-5
#: trained factor tables, the port started from JAX's draw: relative
#: Frobenius distance (bf16 normal-equation build in both, another
#: summation order; measured 6.7e-05 items, 1.3e-05 users)
FACTOR_RTOL = 1e-3
CATS = ("c0", "c1", "c2", "c3")
N_USERS, N_ITEMS = 30, 40


def view_events(seed=0, n_users=N_USERS, n_items=N_ITEMS):
    """Three taste clusters of views (user u likes items i ≡ u mod 3),
    each item's ``$set`` categories (1-2 of four; every 7th item has
    none), a view with no target and a ``buy`` (another event name)."""
    rng = np.random.default_rng(seed)
    out = []

    def add(event, etype, eid, ttype=None, tid=None, props=None):
        out.append(dict(event=event, entity_type=etype, entity_id=eid,
                        target_entity_type=ttype, target_entity_id=tid,
                        properties=props or {}, event_time=T0 + timedelta(seconds=len(out)),
                        event_id=f"e{len(out):05d}"))

    for i in range(n_items):
        if i % 7:
            cats = sorted(rng.choice(CATS, size=int(rng.integers(1, 3)), replace=False))
            add("$set", "item", f"i{i}", props={"categories": [str(c) for c in cats]})
    for u in range(n_users):
        for i in range(n_items):
            if rng.random() < (0.5 if i % 3 == u % 3 else 0.06):
                add("view", "user", f"u{u}", "item", f"i{i}")
    add("view", "user", "u1")                       # no target: skipped
    add("buy", "user", "u2", "item", "i5")          # not a view
    return out


def fill(storage, app_cls, event_cls, datamap_cls, events, app=APP):
    app_id = storage.get_meta_data_apps().insert(app_cls(0, app))
    store = storage.get_events()
    store.init(app_id)
    store.insert_batch([event_cls(**{**e, "properties": datamap_cls(e["properties"])})
                        for e in events], app_id)
    return storage


def insert(storage, event_cls, datamap_cls, app, events) -> None:
    """More events into an app that exists."""
    app_id = storage.get_meta_data_apps().get_by_name(app).id
    storage.get_events().insert_batch(
        [event_cls(**{**e, "properties": datamap_cls(e["properties"])}) for e in events], app_id)


@pytest.fixture
def stores():
    events = view_events()
    return (fill(memory_storage(), App, Event, DataMap, events),
            fill(jax_memory_storage(), JaxApp, JaxEvent, JaxDataMap, events))


@pytest.fixture(autouse=True)
def _model_dir(tmp_path, monkeypatch):
    """Checkpoints land under the test's own directory; JAX's save takes
    its npz backend (its orbax default needs JAX to read)."""
    monkeypatch.setenv("PIO_MODEL_DIR", str(tmp_path))
    monkeypatch.setenv("PIO_SERVING_ANN_BUILD", "0")
    monkeypatch.setattr(jckpt, "_ocp", lambda: None)


def ctx(storage):
    return EngineContext(storage=storage, device="cpu")


def jax_item0(seed, num_items, rank):
    """JAX's initial item factors for ``seed`` (its PRNGKey draw)."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (num_items, rank),
                                        dtype=jnp.float32) / jnp.sqrt(jnp.float32(rank)))


def port_from_jax(jmodel) -> ALSModel:
    """JAX's trained ALSModel carried to the port (factors, id maps, seen
    lists) on the CPU."""
    return ALSModel.from_jax(np.asarray(jmodel.user_factors), np.asarray(jmodel.item_factors),
                             jmodel.user_ids.id_to_ix.to_dict(),
                             jmodel.item_ids.id_to_ix.to_dict(), jmodel.seen_by_user,
                             device="cpu")


def answers(result) -> list[tuple[str, float]]:
    return [(s.item, s.score) for s in result.item_scores]


def assert_same_answer(got, want, tol=SCORE_TOL) -> None:
    """Ids and order equal, scores within ``tol``."""
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=tol, atol=tol)


PARAMS = dict(rank=6, num_iterations=5, lambda_=0.05, alpha=2.0, seed=5)


def trained(port_storage, jax_storage, monkeypatch, template_port, template_jax, algo_name,
            **param_changes):
    """Both packages' algorithm trained on their stores' events, the port
    from JAX's initial draw: (port algorithm, port model, JAX algorithm,
    JAX model, port prepared data). Both port templates train through
    ``similarproduct.train_als``."""
    real = psim.als_train

    def with_jax_item0(coo, *, rank, seed, **kw):
        return real(coo, rank=rank, seed=seed, item0=jax_item0(seed, coo.num_cols, rank), **kw)

    monkeypatch.setattr(psim, "als_train", with_jax_item0)
    variant = {"algorithms": [{"name": algo_name, "params": {}}]}
    out = []
    for module, storage, make_ctx in ((template_port, port_storage, ctx),
                                      (template_jax, jax_storage,
                                       lambda s: JaxEngineContext(storage=s))):
        engine = module.engine_factory()
        ds, prep, algos, _ = engine.make_components(engine.params_from_variant_json(variant))
        ds.params = dataclasses.replace(ds.params, app_name=APP)
        algo = algos[0]
        algo.params = dataclasses.replace(algo.params, use_mesh=False,
                                          **{**PARAMS, **param_changes})
        c = make_ctx(storage)
        pd = prep.prepare(c, ds.read_training(c))
        out.append((algo, algo.train(c, pd), pd))
    (palgo, pmodel, ppd), (jalgo, jmodel, _) = out
    return palgo, pmodel, jalgo, jmodel, ppd


def assert_factors_close(pmodel, jmodel) -> None:
    for side, ids in (("item", pmodel.als.item_ids), ("user", pmodel.als.user_ids)):
        jids = getattr(jmodel.als, f"{side}_ids")
        order = [jids[ids.inverse[ix]] for ix in range(len(ids))]
        want = np.asarray(getattr(jmodel.als, f"{side}_factors"))[order]
        got = getattr(pmodel.als, f"{side}_factors").numpy()
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < FACTOR_RTOL, side


QUERIES = [
    dict(items=("i1",), num=5),
    dict(items=("i1", "i4"), num=10),
    dict(items=("i2",), num=8, categories=("c1",)),
    dict(items=("i2", "i9"), num=40, categories=("c0", "c3")),
    dict(items=("i3",), num=5, categories=()),
    dict(items=("i0",), num=6, white_list=("i2", "i5", "i8", "i11", "i0", "nope")),
    dict(items=("i0",), num=6, white_list=()),
    dict(items=("i6",), num=10, black_list=("i9", "i12", "i15")),
    dict(items=("i6", "i7"), num=12, categories=("c2",), black_list=("i10",),
         white_list=tuple(f"i{i}" for i in range(0, 40, 2))),
    dict(items=("zzz",), num=5),
    dict(items=("i3", "zzz"), num=100),
    dict(items=(), num=5),
]


class TestTemplate:
    def test_training_data_equals_jax(self, stores):
        port_storage, jax_storage = stores
        got = psim.SimilarProductDataSource(psim.DataSourceParams(app_name=APP)).read_training(
            ctx(port_storage))
        want = jsim.SimilarProductDataSource(jsim.DataSourceParams(app_name=APP)).read_training(
            JaxEngineContext(storage=jax_storage))
        assert got.users.tolist() == want.users.tolist()
        assert got.items.tolist() == want.items.tolist()
        np.testing.assert_array_equal(got.ratings, want.ratings)
        assert got.ratings.dtype == np.float32
        assert got.categories == want.categories and "i7" not in got.categories

    def test_defaults_and_params_bind_as_jax(self):
        variant = {"datasource": {"params": {"appName": "A", "eventNames": ["view", "like"]}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": 4, "numIterations": 3, "lambda": 0.2, "alpha": 2.0,
                       "useMesh": False}}]}
        got = psim.engine_factory().params_from_variant_json(variant)
        want = jsim.engine_factory().params_from_variant_json(variant)
        assert [(n, dataclasses.asdict(p)) for n, p in got.algorithm_params_list] == \
            [(n, dataclasses.asdict(p)) for n, p in want.algorithm_params_list]
        assert dataclasses.asdict(got.data_source_params[1]) == \
            dataclasses.asdict(want.data_source_params[1])
        assert dataclasses.asdict(psim.ALSAlgorithmParams()) == \
            dataclasses.asdict(jsim.ALSAlgorithmParams())
        assert issubclass(psim.SimilarALSAlgorithm, ShardedAlgorithm)

    def test_factors_equal_jax(self, stores, monkeypatch):
        palgo, pmodel, jalgo, jmodel, _ = trained(*stores, monkeypatch, psim, jsim, "als")
        assert_factors_close(pmodel, jmodel)
        assert pmodel.categories == jmodel.categories

    @pytest.mark.parametrize("q", QUERIES, ids=lambda q: json.dumps(q)[:60])
    def test_answers_equal_jax(self, stores, monkeypatch, q):
        palgo, _, jalgo, jmodel, _ = trained(*stores, monkeypatch, psim, jsim, "als")
        pmodel = psim.SimilarModel(als=port_from_jax(jmodel.als), categories=jmodel.categories)
        got = answers(palgo.predict(pmodel, psim.Query(**q)))
        want = answers(jalgo.predict(jmodel, jsim.Query(**q)))
        assert_same_answer(got, want)
        if q.get("categories") == () or q.get("white_list") == () or q["items"] in (
                ("zzz",), ()):
            assert got == []
        else:
            assert got and not {i for i, _ in got} & set(q["items"])

    def test_batch_predict_equals_predict(self, stores, monkeypatch):
        palgo, pmodel, *_ = trained(*stores, monkeypatch, psim, jsim, "als")
        queries = [(k, psim.Query(**q)) for k, q in enumerate(QUERIES)]
        batched = palgo.batch_predict(pmodel, queries)
        assert [k for k, _ in batched] == list(range(len(QUERIES)))
        for (_, q), (_, got) in zip(queries, batched):
            assert got == palgo.predict(pmodel, q)

    def test_save_load_round_trip_and_categories_json(self, stores, monkeypatch, tmp_path):
        palgo, pmodel, jalgo, jmodel, _ = trained(*stores, monkeypatch, psim, jsim, "als")
        pctx = EngineContext(WorkflowParams(engine_instance_id="run1"), stores[0], "cpu")
        manifest = palgo.make_persistent_model(pctx, pmodel)
        assert manifest.location == str(tmp_path / "simals_run1_a0")
        jmanifest = jalgo.make_persistent_model(
            JaxEngineContext(workflow_params=JaxWorkflowParams(engine_instance_id="run2"),
                             storage=stores[1]), jmodel)
        read = lambda loc: (tmp_path / loc / "categories.json").read_text()
        assert read("simals_run1_a0") == read(jmanifest.location)
        back = palgo.load_model(pctx, manifest)
        assert back.categories == pmodel.categories
        from_jax = palgo.load_model(pctx, jmanifest)      # the port loads JAX's model
        jax_back = jalgo.load_model(None, manifest)       # and JAX the port's
        for q in QUERIES[:9]:
            want = palgo.predict(pmodel, psim.Query(**q))
            assert palgo.predict(back, psim.Query(**q)) == want
            assert_same_answer(answers(jalgo.predict(jax_back, jsim.Query(**q))),
                               answers(want))
            assert_same_answer(answers(palgo.predict(from_jax, psim.Query(**q))),
                               answers(jalgo.predict(jmodel, jsim.Query(**q))))

    def test_sharding_and_sanity_are_refused(self, stores, monkeypatch):
        monkeypatch.setenv("PIO_TRAIN_SHARD_FACTORS", "1")
        # the env knob without a mesh (use_mesh off): both packages train
        # unsharded, to the same factors
        _, pmodel, _, jmodel, _ = trained(*stores, monkeypatch, psim, jsim, "als")
        assert pmodel.als.factor_shard_ways == 1
        assert_factors_close(pmodel, jmodel)
        with pytest.raises(ValueError, match="no view events"):
            psim.SimilarTrainingData(np.asarray([]), np.asarray([]), np.asarray([]),
                                     {}).sanity_check()
