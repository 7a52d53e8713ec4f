"""The engine-author surface of the port against the JAX package's on the
CPU: ``AverageServing`` and ``Evaluator`` (``controller/base.py``), the
persistent-model contract (``controller/persistent_model.py``) through
``run_train`` → ``load_deployed_engine`` on a stored instance,
``register_backend`` / ``Storage.default()`` / ``EventStore()``
(``storage/registry.py``, ``data/store.py``), the two aggregations of
``core/aggregation.py`` on seeded event streams, and the packages'
exports by name. Mirrors tests/test_persistence_extras.py,
tests/test_aggregation.py and tests/test_storage_conformance.py's
``register_backend`` case.
"""

from __future__ import annotations

import dataclasses
import random
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

import predictionio_tpu as jax_pkg
from predictionio_tpu.controller import base as jbase
from predictionio_tpu.core import aggregation as jagg
from predictionio_tpu.core.datamap import DataMap as JaxDataMap
from predictionio_tpu.core.event import Event as JaxEvent
from predictionio_tpu.utils import reflection as jreflection
import predictionio_tpu_torch as port_pkg
from predictionio_tpu_torch.controller import (
    AverageServing,
    BaseComponent,
    Doer,
    Engine,
    EngineParams,
    Evaluator,
    FirstServing,
    IdentityPreparator,
    LocalAlgorithm,
    Params,
)
from predictionio_tpu_torch.controller.base import PersistentModelManifest
from predictionio_tpu_torch.controller.persistent_model import (
    LocalFileSystemPersistentModel,
    PersistentModel,
    PersistentModelAlgorithmMixin,
)
from predictionio_tpu_torch.core import aggregation as pagg
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.data.store import EventStore
from predictionio_tpu_torch.storage import registry
from predictionio_tpu_torch.storage.memory import MemoryStorageClient
from predictionio_tpu_torch.storage.registry import Storage, StorageError, memory_storage
from predictionio_tpu_torch.utils import reflection
from predictionio_tpu_torch.workflow.context import EngineContext
from predictionio_tpu_torch.workflow.deploy import ServerConfig, load_deployed_engine
from predictionio_tpu_torch.workflow.persistence import load_models
from predictionio_tpu_torch.workflow.train import run_train
from tests.test_torch_evaluation import DSParams, SampleDataSource

# ---------------------------------------------------------------------------
# AverageServing, Evaluator
# ---------------------------------------------------------------------------


class TestAverageServingAndEvaluator:
    @pytest.mark.parametrize("seed, n", [(0, 1), (1, 3), (2, 8)])
    def test_average_serving_equals_jax(self, seed, n):
        preds = [float(x) for x in np.random.default_rng(seed).normal(size=n)]
        got = Doer.create(AverageServing).serve({"q": 1}, preds)
        want = jbase.AverageServing().serve({"q": 1}, preds)
        assert got == want == pytest.approx(sum(preds) / n)

    def test_evaluator_is_an_abstract_component(self):
        with pytest.raises(TypeError):
            Evaluator()

        @dataclasses.dataclass(frozen=True)
        class WeightParams(Params):
            weight: float = 1.0

        class Weighted(Evaluator):
            params_class = WeightParams

            def evaluate(self, ctx, engine_eval_data_set, params):
                return {ep: self.params.weight * sum(p for _, qpa in folds for _, p, _ in qpa)
                        for ep, folds in engine_eval_data_set}

        ev = Doer.create(Weighted, WeightParams(weight=2.0))
        assert isinstance(ev, BaseComponent) and ev.params.weight == 2.0
        got = ev.evaluate(None, [("a", [({}, [(0, 1.5, 0), (1, 2.0, 1)])])], None)
        assert got == {"a": 7.0}
        # the same abstract contract as the JAX class
        assert Evaluator.__abstractmethods__ == jbase.Evaluator.__abstractmethods__


# ---------------------------------------------------------------------------
# The persistent-model contract through train → deploy
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FsModel(LocalFileSystemPersistentModel):
    mult: int = 1


class FsAlgorithm(PersistentModelAlgorithmMixin, LocalAlgorithm):
    """An algorithm whose model persists itself to the local filesystem."""

    def train(self, ctx, pd):
        return FsModel(mult=9)

    def predict(self, model, query):
        return query * model.mult

    def batch_predict(self, model, queries):
        return [(i, q * model.mult) for i, q in queries]


class DeclinedModel(PersistentModel):
    """``save`` declines: the workflow pickles the model itself."""

    def __init__(self, mult=5):
        self.mult = mult

    def save(self, instance_id, params):
        return False

    @classmethod
    def load(cls, instance_id, params):
        raise AssertionError("a declined model is never loaded through load")


class DeclinedAlgorithm(FsAlgorithm):
    def train(self, ctx, pd):
        return DeclinedModel()


def _fs_engine():
    return Engine(SampleDataSource, IdentityPreparator,
                  {"fs": FsAlgorithm, "declined": DeclinedAlgorithm}, FirstServing)


class TestPersistentModel:
    def test_train_then_deploy_roundtrip(self, tmp_path, monkeypatch):
        """tests/test_persistence_extras.py's round trip: the blob holds a
        manifest, the artifact file is keyed by instance id and slot, and
        the deployed engine serves the model its class loaded."""
        monkeypatch.setenv("PIO_MODEL_DIR", str(tmp_path))
        storage = memory_storage()
        engine = _fs_engine()
        params = EngineParams.of(data_source=DSParams(id=1, n_train=3),
                                 algorithms=[("fs", None), ("declined", None)])
        outcome = run_train(engine=engine, engine_params=params, variant={"id": "fs-engine"},
                            storage=storage, ctx=EngineContext(storage=storage, device="cpu"))
        assert outcome.status == "COMPLETED"
        assert (tmp_path / f"{outcome.instance_id}_a0").exists()
        assert not (tmp_path / f"{outcome.instance_id}_a1").exists()
        persisted = load_models(storage, outcome.instance_id, "cpu")
        assert persisted[0] == PersistentModelManifest(
            class_name=f"{__name__}.FsModel", location=f"{outcome.instance_id}_a0")
        assert isinstance(persisted[1], DeclinedModel)

        deployed = load_deployed_engine(
            storage=storage, engine=engine,
            config=ServerConfig(engine_instance_id=outcome.instance_id, device="cpu"))
        assert isinstance(deployed.models[0], FsModel) and deployed.models[0].mult == 9
        assert deployed.query(3) == 27

    def test_pio_train_then_deploy_a_stored_instance(self, tmp_path, monkeypatch, capsys):
        """The same round trip through `pio train` and a deploy of the
        instance it stored in the default sqlite + localfs store."""
        import json

        from predictionio_tpu_torch.cli import pio

        monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "store"))
        monkeypatch.setenv("PIO_MODEL_DIR", str(tmp_path / "models"))
        for k in list(__import__("os").environ):
            if k.startswith("PIO_STORAGE_"):
                monkeypatch.delenv(k)
        monkeypatch.chdir(tmp_path)
        (tmp_path / "engine.json").write_text(json.dumps({
            "id": "fs-engine", "engineFactory": f"{__name__}._fs_engine",
            "datasource": {"params": {"id": 1, "n_train": 3}},
            "algorithms": [{"name": "fs", "params": {}}]}))
        assert pio.main(["train", "--device", "cpu"]) == 0
        assert "COMPLETED" in capsys.readouterr().out
        storage = Storage()
        deployed = load_deployed_engine(storage=storage, config=ServerConfig(device="cpu"))
        assert isinstance(deployed.models[0], FsModel) and deployed.query(2) == 18
        assert (tmp_path / "models" / f"{deployed.instance_id}_a0").exists()
        storage.close()

    def test_location_and_manifest_equal_jax(self, tmp_path, monkeypatch):
        """The same instance id and slot give the same location and the
        same file contents' model in both packages."""
        from predictionio_tpu.controller import persistent_model as jpm

        monkeypatch.setenv("PIO_MODEL_DIR", str(tmp_path))
        ctx = EngineContext(storage=memory_storage(), device="cpu").with_workflow_params(
            engine_instance_id="inst1", algorithm_slot=2)
        manifest = FsAlgorithm().make_persistent_model(ctx, FsModel(mult=4))
        assert manifest.location == "inst1_a2"
        assert FsAlgorithm().load_model(ctx, manifest) == FsModel(mult=4)
        assert jpm.model_base_dir() == str(tmp_path)
        assert FsModel.load("inst1_a2", None).mult == 4
        # a model that is not a PersistentModel passes through
        assert FsAlgorithm().make_persistent_model(ctx, {"w": 1}) == {"w": 1}

    @pytest.mark.parametrize("spec", ["os.path.join", "os.path:join", "collections.OrderedDict"])
    def test_resolve_attr_equals_jax(self, spec):
        assert reflection.resolve_attr(spec) is jreflection.resolve_attr(spec)

    def test_resolve_attr_rejects_a_bare_name(self):
        for resolve in (reflection.resolve_attr, jreflection.resolve_attr):
            with pytest.raises(ValueError, match="invalid object spec"):
                resolve("nomodule")


# ---------------------------------------------------------------------------
# register_backend, Storage.default(), EventStore()
# ---------------------------------------------------------------------------


_MEM_ENV = {
    "PIO_STORAGE_SOURCES_M_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
}


class CountingClient(MemoryStorageClient):
    made = 0

    def __init__(self, config):
        super().__init__(config)
        CountingClient.made += 1


class TestRegistry:
    def test_register_backend_keeps_builtins(self):
        registry.register_backend("custom-test", MemoryStorageClient)
        Storage(_MEM_ENV).verify_all_data_objects()

    def test_registered_type_serves_a_source(self):
        registry.register_backend("counting", CountingClient)
        before = CountingClient.made
        storage = Storage({**_MEM_ENV, "PIO_STORAGE_SOURCES_M_TYPE": "counting"})
        storage.verify_all_data_objects()
        assert CountingClient.made == before + 1  # one client per source

    @pytest.mark.parametrize("type_name", ["postgres", "s3", "elasticsearch"])
    def test_not_ported_types_still_raise(self, type_name):
        storage = Storage({**_MEM_ENV, "PIO_STORAGE_SOURCES_M_TYPE": type_name})
        with pytest.raises(StorageError, match="item 23"):
            storage.get_events()

    def test_unknown_type_raises(self):
        with pytest.raises(StorageError, match="not registered"):
            Storage({**_MEM_ENV, "PIO_STORAGE_SOURCES_M_TYPE": "nosuch"}).get_events()

    def test_default_is_one_storage_until_reset(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
        for k in list(__import__("os").environ):
            if k.startswith("PIO_STORAGE_"):
                monkeypatch.delenv(k)
        Storage.reset_default()
        try:
            first = Storage.default()
            assert Storage.default() is first
            # EventStore() binds the default, as the JAX EventStore does
            store = EventStore()
            assert store.storage is first
            first.get_meta_data_apps()
            assert (tmp_path / "pio.sqlite").exists()
            Storage.reset_default()
            assert Storage.default() is not first
        finally:
            Storage.reset_default()

    def test_event_store_keeps_a_given_storage(self):
        storage = memory_storage()
        assert EventStore(storage).storage is storage


# ---------------------------------------------------------------------------
# aggregate_properties_parallel / aggregate_properties_by_type
# ---------------------------------------------------------------------------

T0 = datetime(2020, 1, 1, tzinfo=timezone.utc)


def _stream(seed: int, n: int = 60):
    """Seeded $set/$unset/$delete streams over 3 users and 2 items, as
    (fields) for either package's Event; distinct times in random order
    (the monoid and the ordered fold settle equal times differently)."""
    rng = random.Random(seed)
    minutes = rng.sample(range(1000), n)
    out = []
    for t in minutes:
        name = rng.choice(["$set", "$set", "$set", "$unset", "$delete", "view"])
        etype = rng.choice(["user", "item"])
        ent = f"{etype[0]}{rng.randrange(3 if etype == 'user' else 2)}"
        props = ({k: rng.randrange(100) for k in rng.sample("abcd", rng.randrange(1, 4))}
                 if name == "$set" else
                 {k: None for k in rng.sample("abcd", 1)} if name == "$unset" else {})
        out.append(dict(event=name, entity_type=etype, entity_id=ent, properties=props,
                        event_time=T0 + timedelta(minutes=t)))
    return out


def _events(stream, jax: bool):
    event_cls, dm = (JaxEvent, JaxDataMap) if jax else (Event, DataMap)
    return [event_cls(**{**e, "properties": dm(e["properties"])}) for e in stream]


def _pm(pm):
    return (dict(pm.fields), pm.first_updated, pm.last_updated)


class TestAggregation:
    @pytest.mark.parametrize("seed", range(6))
    @pytest.mark.parametrize("shards", [1, 3, 7])
    def test_parallel_equals_jax_and_the_local_fold(self, seed, shards):
        stream = [e for e in _stream(seed) if e["entity_type"] == "user"]
        pe, je = _events(stream, False), _events(stream, True)
        cut = [len(stream) * i // shards for i in range(shards + 1)]
        got = pagg.aggregate_properties_parallel(
            [pe[a:b] for a, b in zip(cut, cut[1:])])
        want = jagg.aggregate_properties_parallel(
            [je[a:b] for a, b in zip(cut, cut[1:])])
        assert {k: _pm(v) for k, v in got.items()} == {k: _pm(v) for k, v in want.items()}
        # any partition of the stream agrees with the ordered local fold
        local = pagg.aggregate_properties(pe)
        assert {k: _pm(v) for k, v in got.items()} == {k: _pm(v) for k, v in local.items()}

    @pytest.mark.parametrize("seed", range(6))
    def test_by_type_equals_jax(self, seed):
        stream = _stream(seed)
        got = pagg.aggregate_properties_by_type(_events(stream, False))
        want = jagg.aggregate_properties_by_type(_events(stream, True))
        assert sorted(got) == sorted(want)
        for t in want:
            assert {k: _pm(v) for k, v in got[t].items()} == \
                {k: _pm(v) for k, v in want[t].items()}


# ---------------------------------------------------------------------------
# Package exports
# ---------------------------------------------------------------------------


class TestExports:
    @pytest.mark.parametrize("sub", ["", "api", "storage", "workflow", "controller", "e2"])
    def test_every_jax_export_is_exported(self, sub):
        import importlib

        jax_mod = importlib.import_module(jax_pkg.__name__ + (f".{sub}" if sub else ""))
        port_mod = importlib.import_module(port_pkg.__name__ + (f".{sub}" if sub else ""))
        assert set(jax_mod.__all__) <= set(port_mod.__all__)
        for name in port_mod.__all__:
            assert getattr(port_mod, name) is not None

    def test_version_and_top_level_types(self):
        assert port_pkg.__version__ == jax_pkg.__version__
        assert port_pkg.Event is Event and port_pkg.DataMap is DataMap
