"""The port's storage-backed train → deploy path on the CPU, against the
JAX package's: the recommendation template's training read (through the
columnar ``EventStore.scan``) equal to JAX's array for array on one
sqlite file; ``run_train``'s engine-instance rows (INIT → COMPLETED /
INTERRUPTED / FAILED) equal to JAX's field by field; the model blob's
checksum (``workflow/persistence.py``) refusing a corrupted blob at
deploy; and ``load_deployed_engine`` by instance id or as the latest
COMPLETED one, from a second Storage over the same files.
"""

from __future__ import annotations

import dataclasses
import json
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from predictionio_tpu.controller import engine as jengine_mod
from predictionio_tpu.core.datamap import DataMap as JaxDataMap
from predictionio_tpu.core.event import Event as JaxEvent
from predictionio_tpu.storage.base import App as JaxApp
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.templates import recommendation as jrec
from predictionio_tpu.workflow import train as jtrain
from predictionio_tpu.workflow.context import EngineContext as JaxEngineContext
from predictionio_tpu.workflow.context import WorkflowParams as JaxWorkflowParams
from predictionio_tpu_torch.controller import PersistentModelManifest
from predictionio_tpu_torch.controller import engine as pengine_mod
from predictionio_tpu_torch.controller.base import (
    Algorithm,
    DataSource,
    FirstServing,
    IdentityPreparator,
)
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.data.store import AppNotFoundError
from predictionio_tpu_torch.storage.base import App, Model
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.templates import recommendation as prec
from predictionio_tpu_torch.workflow import persistence
from predictionio_tpu_torch.workflow.context import EngineContext, WorkflowParams
from predictionio_tpu_torch.workflow.deploy import (
    ServerConfig,
    load_deployed_engine,
    resolve_engine_instance,
)
from predictionio_tpu_torch.workflow.train import _algo_params_json, run_train

T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
PORT_FACTORY = "predictionio_tpu_torch.templates.recommendation.engine_factory"
JAX_FACTORY = "predictionio_tpu.templates.recommendation.engine_factory"
ALGORITHMS = [{"name": "als", "params": {"rank": 4, "numIterations": 3, "lambda": 0.05,
                                         "seed": 1, "useMesh": False}}]


def _variant(factory: str, app: str = "RecApp", **extra) -> dict:
    return {"id": "rec", "version": "2", "variantId": "small", "engineFactory": factory,
            "datasource": {"params": {"appName": app}}, "algorithms": ALGORITHMS, **extra}


def _event_specs(n_users=24, n_items=300, seed=0) -> list[dict]:
    """Rate and buy events with duplicates, a missing, a non-numeric and
    a string rating, an event with no target and one of another name;
    more than one columnar batch (4,096 rows)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in range(4_200):
        u, i = int(rng.integers(n_users)), int(rng.integers(n_items))
        name = "rate" if rng.random() < 0.8 else "buy"
        props = {"rating": float(rng.integers(1, 6))} if name == "rate" else {}
        out.append(dict(event=name, entity_id=f"u{u}", target_entity_id=f"i{i}",
                        properties=props, minutes=n))
    for n, props in ((5, {}), (6, {"rating": "bad"}), (7, {"rating": "4.5"})):
        out[n].update(event="rate", properties=props)
    out[8]["target_entity_id"] = None
    out[9]["event"] = "view"
    return out


def _fill(storage, app_cls, event_cls, datamap_cls, specs, app="RecApp"):
    app_id = storage.get_meta_data_apps().insert(app_cls(0, app))
    storage.get_events().insert_batch([event_cls(
        event=s["event"], entity_type="user", entity_id=s["entity_id"],
        target_entity_type="item" if s["target_entity_id"] else None,
        target_entity_id=s["target_entity_id"], properties=datamap_cls(s["properties"]),
        event_time=T0 + timedelta(minutes=s["minutes"]), event_id=f"e{s['minutes']:05d}")
        for s in specs], app_id)
    return app_id


@pytest.fixture
def sqlite_env(tmp_path, monkeypatch):
    """One sqlite + localfs store that both packages open, holding the
    events; checkpoints of both packages under the test's directory."""
    monkeypatch.setenv("PIO_MODEL_DIR", str(tmp_path / "checkpoints"))
    env = {"PIO_FS_BASEDIR": str(tmp_path / "store")}
    writer = JaxStorage(env)
    _fill(writer, JaxApp, JaxEvent, JaxDataMap, _event_specs())
    writer.close()
    return env


def _ctx(storage, **wp):
    return EngineContext(WorkflowParams(**wp), storage=storage, device="cpu")


class TestReadFromSqlite:
    def test_ratings_equal_jax_array_for_array(self, sqlite_env):
        port_storage, jax_storage = Storage(sqlite_env), JaxStorage(sqlite_env)
        got = prec.RecommendationDataSource(prec.DataSourceParams(app_name="RecApp")
                                            ).read_training(_ctx(port_storage))
        want = jrec.RecommendationDataSource(jrec.DataSourceParams(app_name="RecApp")
                                             ).read_training(JaxEngineContext(storage=jax_storage))
        for name in ("users", "items", "ratings"):
            g, w = getattr(got, name), getattr(want, name)
            assert g.dtype == w.dtype and g.tolist() == w.tolist(), name
        assert len(got.users) == 4_200 - 4       # missing, bad, no target, other name
        assert got.ratings[5] == 4.5             # the string rating parses, as in JAX

    def test_folds_equal_jax(self, sqlite_env):
        params = dict(app_name="RecApp", eval_k=3)
        got = prec.RecommendationDataSource(prec.DataSourceParams(**params)).read_eval(
            _ctx(Storage(sqlite_env)))
        want = jrec.RecommendationDataSource(jrec.DataSourceParams(**params)).read_eval(
            JaxEngineContext(storage=JaxStorage(sqlite_env)))
        for (gtd, gei, gqa), (wtd, wei, wqa) in zip(got, want):
            assert gei == wei and gtd.users.tolist() == wtd.users.tolist()
            assert [(q.user, q.num, a) for q, a in gqa] == [(q.user, q.num, a) for q, a in wqa]


def _rows(storage, spy_rows: list) -> list[dict]:
    """Every instance row as the fields run_train writes, ids and times
    left out, the engine factory's package normalized."""
    out = []
    for i in spy_rows + storage.get_meta_data_engine_instances().get_all():
        d = dataclasses.asdict(i)
        for k in ("id", "start_time", "completion_time"):
            d.pop(k)
        d["engine_factory"] = d["engine_factory"].replace("predictionio_tpu_torch.",
                                                          "predictionio_tpu.")
        out.append(d)
    return out


def _spy_init(monkeypatch, module, storages: list, seen: list):
    """Record the instance rows as Engine.train starts (the INIT state)."""
    real = module.Engine.train

    def train(self, ctx, *a, **kw):
        seen.extend(ctx.storage.get_meta_data_engine_instances().get_all())
        return real(self, ctx, *a, **kw)

    monkeypatch.setattr(module.Engine, "train", train)


class TestEngineInstanceRows:
    @pytest.mark.parametrize("case", ["completed", "interrupted", "failed"])
    def test_rows_equal_jax(self, sqlite_env, monkeypatch, case):
        port_seen, jax_seen = [], []
        _spy_init(monkeypatch, pengine_mod, [], port_seen)
        _spy_init(monkeypatch, jengine_mod, [], jax_seen)
        app = "Nope" if case == "failed" else "RecApp"
        wp = dict(batch="b1", stop_after_read=case == "interrupted")
        port_storage = Storage(sqlite_env)
        jax_storage = JaxStorage({**sqlite_env, "PIO_FS_BASEDIR": sqlite_env["PIO_FS_BASEDIR"]
                                  + "-jax"})
        _fill(jax_storage, JaxApp, JaxEvent, JaxDataMap, _event_specs()[:200])
        runs = []
        for fn, kw in ((run_train, dict(variant=_variant(PORT_FACTORY, app),
                                        workflow_params=WorkflowParams(**wp),
                                        storage=port_storage,
                                        ctx=_ctx(port_storage, **wp))),
                       (jtrain.run_train, dict(variant=_variant(JAX_FACTORY, app),
                                               workflow_params=JaxWorkflowParams(**wp),
                                               storage=jax_storage))):
            if case == "failed":
                with pytest.raises((AppNotFoundError, LookupError, KeyError, ValueError)):
                    fn(**kw)
                runs.append(None)
            else:
                runs.append(fn(**kw))
        got, want = _rows(port_storage, port_seen), _rows(jax_storage, jax_seen)
        assert got == want
        assert [r["status"] for r in got] == ["INIT", {"completed": "COMPLETED",
                                                       "interrupted": "INTERRUPTED",
                                                       "failed": "FAILED"}[case]]
        assert got[0]["algorithms_params"] == _algo_params_json(
            prec.engine_factory().params_from_variant_json(
                _variant(PORT_FACTORY)).algorithm_params_list)
        if case != "failed":
            assert runs[0].status == runs[1].status
            assert runs[0].instance_id == port_storage.get_meta_data_engine_instances(
            ).get_all()[0].id

    def test_chip_smoke_algorithms_text_is_jax(self):
        """chip_smoke.py checks phase 16's instance row against this
        literal, the JAX package's text for the same variant."""
        import chip_smoke

        variant = {"algorithms": chip_smoke.PIO_REC_ALGORITHMS}
        assert chip_smoke.PIO_REC_ALGORITHMS_JSON == jtrain._algo_params_json(
            jrec.engine_factory().params_from_variant_json(variant).algorithm_params_list)


@dataclasses.dataclass
class Held:
    """A model that the default ``make_persistent_model`` persists itself."""

    w: torch.Tensor
    parts: tuple


class _HeldSource(DataSource):
    def read_training(self, ctx):
        return np.arange(6, dtype=np.float32).reshape(2, 3)


class _HeldAlgorithm(Algorithm):
    """Keeps its weights as tensors and persists by the default hook."""

    def train(self, ctx, pd):
        w = torch.as_tensor(pd, device=ctx.device)
        return Held(w, (w.to(torch.bfloat16), [torch.arange(3, device=ctx.device)]))

    def predict(self, model, query):
        return (model.w @ torch.as_tensor(query, dtype=torch.float32)).tolist()


def _held_engine():
    return pengine_mod.Engine(_HeldSource, IdentityPreparator, _HeldAlgorithm, FirstServing)


@pytest.fixture
def trained(sqlite_env):
    """A recommendation engine trained on the CPU into the sqlite + localfs
    store; (Storage, instance id)."""
    storage = Storage(sqlite_env)
    outcome = run_train(variant=_variant(PORT_FACTORY), ctx=_ctx(storage))
    assert outcome.status == "COMPLETED"
    return storage, outcome.instance_id


class TestDeploy:
    def test_by_id_and_latest_from_a_second_storage(self, sqlite_env, trained):
        storage, iid = trained
        later = run_train(variant=_variant(PORT_FACTORY), ctx=_ctx(storage)).instance_id
        fresh = Storage(sqlite_env)
        by_id = load_deployed_engine(fresh, ServerConfig(engine_instance_id=iid, device="cpu"))
        latest = load_deployed_engine(fresh, ServerConfig(engine_id="rec", engine_version="2",
                                                          engine_variant="small",
                                                          device="cpu"))
        anyone = load_deployed_engine(fresh, ServerConfig(device="cpu"))
        assert (by_id.instance_id, latest.instance_id, anyone.instance_id) == (iid, later, later)
        q = prec.Query(user="u3", num=5)
        assert by_id.query(q) == latest.query(q) and by_id.query(q).item_scores
        assert by_id.device == torch.device("cpu")
        with pytest.raises(LookupError, match="not found"):
            resolve_engine_instance(fresh, ServerConfig(engine_instance_id="nope"))
        with pytest.raises(LookupError, match="pio train"):
            resolve_engine_instance(fresh, ServerConfig(engine_id="other"))

    @pytest.mark.parametrize("damage", ["flip", "truncate_header", "truncate_payload"])
    def test_corrupted_blob_is_refused(self, sqlite_env, trained, damage):
        storage, iid = trained
        models = storage.get_model_data_models()
        blob = bytearray(models.get(iid).models)
        assert blob.startswith(b"PIOM\x01")
        if damage == "flip":
            blob[len(blob) // 2] ^= 0x01
        elif damage == "truncate_header":
            blob = blob[:20]
        else:
            blob = blob[:-7]
        models.insert(Model(iid, bytes(blob)))
        with pytest.raises(persistence.ModelIntegrityError):
            load_deployed_engine(Storage(sqlite_env), ServerConfig(engine_instance_id=iid,
                                                                   device="cpu"))

    def test_blob_modes(self, tmp_path):
        """A model persists as host arrays and comes back as tensors on
        the deploy's device in their own dtypes, a manifest as itself,
        None as None; a blob without the header is refused."""
        manifest = PersistentModelManifest("x.Y", str(tmp_path))
        w = torch.tensor([1.5, -2.0])
        blob = persistence.serialize_models(
            [Held(w, (w.to(torch.bfloat16), [torch.arange(3)])), manifest, None])
        held, back_manifest, none = persistence.deserialize_models(blob, "cpu")
        assert isinstance(held.w, torch.Tensor) and torch.equal(held.w, w)
        assert held.parts[0].dtype == torch.bfloat16 and held.parts[0].tolist() == [1.5, -2.0]
        assert held.parts[1][0].dtype == torch.int64 and held.parts[1][0].tolist() == [0, 1, 2]
        assert back_manifest == manifest and none is None
        header = len(b"PIOM\x01") + 32
        with pytest.raises(persistence.ModelIntegrityError, match="header"):
            persistence.deserialize_models(blob[header:], "cpu")

    def test_default_persisted_model_deploys_and_serves(self, tmp_path):
        """train → deploy → query for an algorithm that keeps the default
        ``make_persistent_model``: the deployed model holds tensors on
        the deploy's device and answers as the trained one."""
        storage = Storage({"PIO_FS_BASEDIR": str(tmp_path / "store")})
        engine = _held_engine()
        outcome = run_train(engine=engine, variant={"id": "held"}, ctx=_ctx(storage))
        assert outcome.status == "COMPLETED"
        deployed = load_deployed_engine(
            Storage({"PIO_FS_BASEDIR": str(tmp_path / "store")}),
            ServerConfig(engine_instance_id=outcome.instance_id, device="cpu"), engine=engine)
        model = deployed.models[0]
        assert isinstance(model.w, torch.Tensor) and model.w.device == torch.device("cpu")
        assert model.parts[0].dtype == torch.bfloat16
        assert deployed.query([1.0, 0.0, 2.0]) == [4.0, 13.0]


class TestEngineJson:
    @pytest.mark.parametrize("doc", [
        {"engineFactory": PORT_FACTORY, "id": "rec", "algorithms": ALGORITHMS},
        {"id": "no-factory"},
        None,
    ], ids=["variant", "no_factory", "missing"])
    def test_load_variant_equals_jax(self, tmp_path, doc):
        from predictionio_tpu.workflow.engine_json import load_variant as jax_load
        from predictionio_tpu_torch.workflow.engine_json import load_variant

        path = tmp_path / "engine.json"
        if doc is not None:
            path.write_text(json.dumps(doc))
        if doc is None or "engineFactory" not in doc:
            errors = []
            for fn in (load_variant, jax_load):
                with pytest.raises((FileNotFoundError, ValueError)) as err:
                    fn(str(path))
                errors.append((type(err.value), str(err.value)))
            assert errors[0] == errors[1]
        else:
            assert load_variant(str(path)) == jax_load(str(path)) == doc
