"""The mesh paths of the port's models and engines, held against JAX's
8-device CPU mesh: naive Bayes counts and the logreg fit over a "data"
axis (the twins of tests/test_naive_bayes.py's mesh tests), sharded
checkpoints (tests/test_persistence_extras.py's TestShardedCheckpoint),
sharded models saved by one package and served by the other, and the
engine path: ``run_train`` of an engine.json with ``meshConf`` and
``shardFactors`` over a context given its devices, then
``load_deployed_engine`` onto a 2-way serving mesh. The port's meshes
lay their positions over ``["cpu"] * n``.
"""

from __future__ import annotations

from datetime import datetime, timedelta, timezone

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec

from predictionio_tpu.models import als as jmodels
from predictionio_tpu.models import logreg as jlr
from predictionio_tpu.models import naive_bayes as jnb
from predictionio_tpu.utils import checkpoint as jckpt
from predictionio_tpu.utils.bimap import BiMap as JaxBiMap
from predictionio_tpu.utils.bimap import EntityIdIxMap as JaxEntityIdIxMap
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.models import logreg as plr
from predictionio_tpu_torch.models import naive_bayes as pnb
from predictionio_tpu_torch.models.als import ALSModel
from predictionio_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedArray,
    device_put,
    model_sharding,
)
from predictionio_tpu_torch.storage.base import App
from predictionio_tpu_torch.storage.registry import memory_storage
from predictionio_tpu_torch.templates import classification as pcls
from predictionio_tpu_torch.templates.recommendation import Query
from predictionio_tpu_torch.utils import checkpoint as pckpt
from predictionio_tpu_torch.utils.bimap import BiMap, EntityIdIxMap
from predictionio_tpu_torch.workflow.context import EngineContext, WorkflowParams
from predictionio_tpu_torch.workflow.deploy import ServerConfig, load_deployed_engine
from predictionio_tpu_torch.workflow.train import run_train

pytestmark = pytest.mark.mesh

MESH_SHAPES = ((1, 8), (2, 4), (4, 2), (8, 1))
SHAPE_IDS = [f"{d}x{m}" for d, m in MESH_SHAPES]
#: naive Bayes against JAX's sharded counts (tests/test_naive_bayes.py)
NB_RTOL = 1e-5
#: logreg after 10 Adam steps against JAX's sharded fit on the same mesh
#: (tests/test_torch_classification.py's unsharded parity tolerance)
LOGREG_TOL = 2e-6
SCORE_TOL = 1e-5


def port_mesh(shape, n=8) -> Mesh:
    return Mesh(np.asarray(["cpu"] * n, dtype=object).reshape(shape), ("data", "model"))


def jax_mesh(shape):
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8-device CPU topology")
    return JaxMesh(np.asarray(jax.devices()[:8]).reshape(shape), ("data", "model"))


@pytest.fixture
def dataset():
    rng = np.random.default_rng(0)
    n, f, c = 200, 6, 3
    labels = rng.integers(0, c, size=n).astype(np.int32)
    centers = rng.uniform(1, 10, size=(c, f))
    return rng.poisson(centers[labels]).astype(np.float32), labels, c


class TestNaiveBayesMesh:
    @pytest.mark.parametrize("shape", MESH_SHAPES, ids=SHAPE_IDS)
    def test_multinomial_mesh_equals_single_device(self, dataset, shape):
        features, labels, c = dataset
        single = pnb.train_multinomial(features, labels, c, device="cpu")
        sharded = pnb.train_multinomial(features, labels, c, mesh=port_mesh(shape))
        want = jnb.train_multinomial(features, labels, c, mesh=jax_mesh(shape))
        for field in ("log_prior", "log_theta"):
            assert torch.equal(getattr(sharded, field), getattr(single, field))
            np.testing.assert_allclose(getattr(sharded, field).numpy(),
                                       np.asarray(getattr(want, field)), rtol=NB_RTOL)

    def test_multinomial_mesh_with_ragged_length(self):
        """37 rows on an 8-wide data axis: the padding rows count nothing."""
        rng = np.random.default_rng(1)
        features = rng.poisson(3, size=(37, 4)).astype(np.float32)
        labels = rng.integers(0, 2, size=37).astype(np.int32)
        single = pnb.train_multinomial(features, labels, 2, device="cpu")
        sharded = pnb.train_multinomial(features, labels, 2, mesh=port_mesh((8, 1)))
        want = jnb.train_multinomial(features, labels, 2, mesh=jax_mesh((8, 1)))
        assert torch.equal(sharded.log_theta, single.log_theta)
        np.testing.assert_allclose(sharded.log_theta.numpy(), np.asarray(want.log_theta),
                                   rtol=NB_RTOL)

    def test_categorical_mesh_equals_single(self):
        rng = np.random.default_rng(2)
        features = rng.integers(0, 5, size=(50, 3)).astype(np.int32)
        features[3, 1] = -1                       # missing: counts nowhere
        labels = rng.integers(0, 4, size=50).astype(np.int32)
        single = pnb.train_categorical(features, labels, 4, 5, device="cpu")
        sharded = pnb.train_categorical(features, labels, 4, 5, mesh=port_mesh((4, 2)))
        want = jnb.train_categorical(features, labels, 4, 5, mesh=jax_mesh((4, 2)))
        for field in ("log_prior", "log_likelihood", "default_log"):
            assert torch.equal(getattr(sharded, field), getattr(single, field))
            np.testing.assert_allclose(getattr(sharded, field).numpy(),
                                       np.asarray(getattr(want, field)), rtol=NB_RTOL)


class TestLogRegMesh:
    @pytest.mark.parametrize("shape", MESH_SHAPES, ids=SHAPE_IDS)
    def test_fit_equals_jax_on_the_same_mesh(self, shape):
        """The global mask count normalizes every shard's partials: the
        fit is JAX's sharded fit on the same mesh, its padding rows (603
        rows: a zero mask) included."""
        rng = np.random.default_rng(3)
        y = rng.integers(0, 4, 603).astype(np.int32)
        X = (rng.standard_normal((4, 10)) * 3.0)[y] + rng.standard_normal((603, 10))
        X = X.astype(np.float32)
        got = plr.train_logreg(X, y, 4, iterations=10, mesh=port_mesh(shape))
        want = jlr.train_logreg(X, y, 4, iterations=10, mesh=jax_mesh(shape))
        np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights), rtol=0,
                                   atol=LOGREG_TOL)


class TestShardedCheckpoint:
    def test_roundtrip_with_mesh_placement(self, tmp_path):
        mesh = Mesh(np.asarray(["cpu"] * 4, dtype=object), ("model",))
        sh = model_sharding(mesh, ndim=2)
        arr = torch.arange(32, dtype=torch.float32).reshape(8, 4)
        placed = device_put(arr, sh)
        assert pckpt.save_sharded(str(tmp_path / "ckpt"), {"user": placed}) == "npz"
        out = pckpt.load_sharded(str(tmp_path / "ckpt"), shardings={"user": sh})
        assert isinstance(out["user"], ShardedArray) and out["user"].sharding == sh
        np.testing.assert_array_equal(np.asarray(out["user"]), arr.numpy())
        # the file is the whole array's: the JAX package reads it
        np.testing.assert_array_equal(jckpt.load_sharded(str(tmp_path / "ckpt"))["user"],
                                      arr.numpy())


def _ids(prefix, n):
    return {f"{prefix}{i}": i for i in range(n)}


class TestShardedModelsAcrossPackages:
    U, I, K = 40, 64, 8

    def _factors(self):
        rng = np.random.default_rng(21)
        return (rng.standard_normal((self.U, self.K)).astype(np.float32),
                rng.standard_normal((self.I, self.K)).astype(np.float32))

    def test_jax_saved_sharded_model_serves_sharded_in_the_port(self, tmp_path, monkeypatch):
        monkeypatch.setattr(jckpt, "_ocp", lambda: None)   # the npz backend both read
        monkeypatch.setenv("PIO_SERVING_ANN_BUILD", "0")
        users, items = self._factors()
        row = JaxNamedSharding(jax_mesh((1, 8)), PartitionSpec("model", None))
        jm = jmodels.ALSModel(
            rank=self.K, user_factors=jax.device_put(jnp.asarray(users), row),
            item_factors=jax.device_put(jnp.asarray(items), row),
            user_ids=JaxEntityIdIxMap(JaxBiMap(_ids("u", self.U))),
            item_ids=JaxEntityIdIxMap(JaxBiMap(_ids("i", self.I))),
            seen_by_user={0: np.asarray([1, 2, 3], dtype=np.int32)})
        assert jm.factor_shard_ways == 8
        jm.save(str(tmp_path))
        port = ALSModel.load(str(tmp_path), "cpu", devices=["cpu"] * 8)
        assert port.factor_shard_ways == 8
        for uid in ("u0", "u5", "u11"):
            got, want = port.recommend(uid, 10), jm.recommend(uid, 10)
            assert [x[0] for x in got] == [x[0] for x in want]
            np.testing.assert_allclose([x[1] for x in got], [x[1] for x in want],
                                       atol=SCORE_TOL)

    def test_port_saved_sharded_model_serves_sharded_in_jax(self, tmp_path, monkeypatch):
        monkeypatch.setattr(jckpt, "_ocp", lambda: None)
        monkeypatch.setenv("PIO_SERVING_ANN_BUILD", "0")
        users, items = self._factors()
        mesh = port_mesh((2, 4))
        port = ALSModel(
            rank=self.K, user_factors=device_put(users, model_sharding(mesh)),
            item_factors=device_put(items, model_sharding(mesh)),
            user_ids=EntityIdIxMap(BiMap(_ids("u", self.U))),
            item_ids=EntityIdIxMap(BiMap(_ids("i", self.I))),
            seen_by_user={0: np.asarray([1, 2, 3], dtype=np.int32)})
        assert port.factor_shard_ways == 4
        port.save(str(tmp_path))
        jm = jmodels.ALSModel.load(str(tmp_path))
        assert jm.factor_shard_ways == 8     # JAX reshards over its 8 devices
        for uid in ("u0", "u5", "u11"):
            got, want = port.recommend(uid, 10), jm.recommend(uid, 10)
            assert [x[0] for x in got] == [x[0] for x in want]
            np.testing.assert_allclose([x[1] for x in got], [x[1] for x in want],
                                       atol=SCORE_TOL)


FACTORY = "predictionio_tpu_torch.templates.recommendation.engine_factory"
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)


def _rec_storage():
    """Two taste clusters of rate events (even users like even items)."""
    rng = np.random.default_rng(0)
    storage = memory_storage()
    app_id = storage.get_meta_data_apps().insert(App(0, "RecApp"))
    events = []
    for u in range(24):
        for i in range(16):
            if i % 2 == u % 2 and rng.random() < 0.8 or rng.random() < 0.1:
                events.append(Event(
                    event="rate", entity_type="user", entity_id=f"u{u}",
                    target_entity_type="item", target_entity_id=f"i{i}",
                    properties=DataMap({"rating": 5.0 if i % 2 == u % 2 else 1.0}),
                    event_time=T0 + timedelta(seconds=len(events)),
                    event_id=f"e{len(events):05d}"))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch(events, app_id)
    return storage


def _variant(**algo):
    return {"engineFactory": FACTORY, "datasource": {"params": {"appName": "RecApp"}},
            "algorithms": [{"name": "als", "params": {"rank": 8, "numIterations": 8,
                                                      "lambda": 0.05, "seed": 1, **algo}}]}


class TestEnginePath:
    def test_mesh_conf_trains_sharded_and_serves_sharded(self, tmp_path, monkeypatch):
        """engine.json's meshConf and shardFactors over a context given 4
        positions: the instance records the meshConf, the trained model is
        row-sharded 2 ways, a 2-device deploy restores it sharded, and its
        answers are those of the same engine trained on one device."""
        monkeypatch.setenv("PIO_MODEL_DIR", str(tmp_path))
        monkeypatch.setenv("PIO_SERVING_ANN_BUILD", "0")
        storage = _rec_storage()
        mesh_conf = {"axes": {"data": 2, "model": 2}}
        sharded = run_train(variant={**_variant(shardFactors=True), "meshConf": mesh_conf},
                            ctx=EngineContext(storage=storage, device="cpu",
                                              devices=["cpu"] * 4))
        assert sharded.status == "COMPLETED"
        row = storage.get_meta_data_engine_instances().get(sharded.instance_id)
        assert row.mesh_conf == mesh_conf
        plain = run_train(variant=_variant(), ctx=EngineContext(storage=storage, device="cpu"))
        assert storage.get_meta_data_engine_instances().get(plain.instance_id).mesh_conf == {}
        served = load_deployed_engine(
            storage, ServerConfig(engine_instance_id=sharded.instance_id, device="cpu"),
            ctx=EngineContext(storage=storage, device="cpu", devices=["cpu"] * 2))
        assert served.models[0].factor_shard_ways == 2
        assert isinstance(served.models[0].item_factors, ShardedArray)
        one = load_deployed_engine(
            storage, ServerConfig(engine_instance_id=plain.instance_id, device="cpu"))
        assert one.models[0].factor_shard_ways == 1
        queries = [{"user": f"u{u}", "num": n} for u in range(0, 24, 3) for n in (3, 10)]
        want = [one.query(Query(**q)) for q in queries]
        for got in ([served.query(Query(**q)) for q in queries],
                    served.query_batch([Query(**q) for q in queries])):
            for a, b in zip(got, want):
                assert [s.item for s in a.item_scores] == [s.item for s in b.item_scores]
                np.testing.assert_allclose([s.score for s in a.item_scores],
                                           [s.score for s in b.item_scores], atol=SCORE_TOL)

    def test_classification_template_counts_over_the_mesh(self):
        rng = np.random.default_rng(4)
        y = rng.integers(0, 3, 90).astype(np.int32)
        X = rng.poisson(rng.uniform(1, 6, (3, 5))[y]).astype(np.float32)
        td = pcls.TrainingData(features=X, labels=y,
                               label_map=pcls.BiMap({"a": 0, "b": 1, "c": 2}))
        algo = pcls.NaiveBayesAlgorithm(pcls.AlgorithmParams())
        got = algo.train(EngineContext(WorkflowParams(), device="cpu", devices=["cpu"] * 4),
                         td)
        want = algo.train(EngineContext(device="cpu"), td)
        assert torch.equal(got.nb.log_theta, want.nb.log_theta)
        lr = pcls.LogisticRegressionAlgorithm(pcls.LogRegAlgorithmParams(iterations=10))
        fit = lr.train(EngineContext(device="cpu", devices=["cpu"] * 4), td).lr.weights
        torch.testing.assert_close(fit, lr.train(EngineContext(device="cpu"), td).lr.weights,
                                   rtol=1e-3, atol=1e-3)

