"""The port's sessionrec training slice on the CPU: events in the port's
memory event store → ``run_train`` → an engine instance and a checkpoint
behind its manifest → ``load_deployed_engine`` → queries, held against
the JAX package's
template on the same events (read and index exactly; the trained model
by what it answers, as tests/test_sessionrec_template.py holds the JAX
one).
"""

from __future__ import annotations

import dataclasses
import re
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from predictionio_tpu.core.event import Event as JaxEvent
from predictionio_tpu.core.event import EventValidation as JaxEventValidation
from predictionio_tpu.storage.base import App as JaxApp
from predictionio_tpu.templates import sessionrec as jsess
from predictionio_tpu.utils.testing import memory_storage as jax_memory_storage
from predictionio_tpu.workflow.context import EngineContext as JaxEngineContext
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.core.event import Event, EventValidation, EventValidationError
from predictionio_tpu_torch.data.store import AppNotFoundError, EventStore
from predictionio_tpu_torch.storage.base import App, Channel
from predictionio_tpu_torch.storage.registry import Storage, StorageError, memory_storage
from predictionio_tpu_torch.templates import sessionrec
from predictionio_tpu_torch.workflow.context import EngineContext, WorkflowParams
from predictionio_tpu_torch.workflow.deploy import ServerConfig, load_deployed_engine
from predictionio_tpu_torch.workflow.train import format_stage_times, run_train

N_USERS = 48
CYCLE = 10  # items walk i0 -> i1 -> ... -> i9 -> i0
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)

VARIANT = {
    "id": "sess",
    "engineFactory": "predictionio_tpu_torch.templates.sessionrec.engine_factory",
    "datasource": {"params": {"app_name": "SessApp"}},
    "algorithms": [
        {"name": "seqrec",
         "params": {"d_model": 32, "n_layers": 2, "n_heads": 2,
                    "max_len": 16, "epochs": 25, "batch_size": 16,
                    "lr": 3e-3, "seed": 0}}
    ],
}


def _cycle_events():
    """tests/test_sessionrec_template.py's events: every user walks the
    item cycle from a random start. Ids are fixed, so both stores break
    time ties alike; u1's last two views share one time, and a few
    events have no target or another name."""
    rng = np.random.default_rng(0)
    out = []
    for u in range(N_USERS):
        start = int(rng.integers(CYCLE))
        for t in range(8):
            minute = u * 100 + (6 if (u == 1 and t == 7) else t)
            out.append(dict(event="view", entity_type="user", entity_id=f"u{u}",
                            target_entity_type="item",
                            target_entity_id=f"i{(start + t) % CYCLE}",
                            event_time=T0 + timedelta(minutes=minute),
                            event_id=f"e{u:03d}{t}"))
    out.append(dict(event="rate", entity_type="user", entity_id="u0",
                    target_entity_type="item", target_entity_id="i9",
                    event_time=T0, event_id="x1"))
    out.append(dict(event="view", entity_type="user", entity_id="u2",
                    event_time=T0, event_id="x2"))
    out.append(dict(event="view", entity_type="user", entity_id="solo",
                    target_entity_type="item", target_entity_id="i1",
                    event_time=T0, event_id="x3"))
    return out


def _fill(storage, app_cls, event_cls, events, app_name="SessApp"):
    app_id = storage.get_meta_data_apps().insert(app_cls(0, app_name))
    store = storage.get_events()
    store.init(app_id)
    store.insert_batch([event_cls(**e) for e in events], app_id)
    return storage


@pytest.fixture
def stores():
    """(port storage, JAX storage) holding the same events."""
    events = _cycle_events()
    return (_fill(memory_storage(), App, Event, events),
            _fill(jax_memory_storage(), JaxApp, JaxEvent, events))


def _ctx(storage, **wp):
    return EngineContext(WorkflowParams(**wp), storage=storage, device="cpu")


@pytest.fixture(autouse=True)
def _model_dir(tmp_path, monkeypatch):
    """Checkpoints land under the test's own directory."""
    monkeypatch.setenv("PIO_MODEL_DIR", str(tmp_path))


def _deploy(storage, instance_id):
    return load_deployed_engine(storage, ServerConfig(engine_instance_id=instance_id,
                                                      device="cpu"))


class TestDataSourceVsJax:
    @pytest.mark.parametrize("min_len", [2, 8, 9])
    def test_read_training_equals_jax(self, stores, min_len):
        port, jax_storage = stores
        params = dict(app_name="SessApp", min_sequence_len=min_len)
        got = sessionrec.SessionDataSource(
            sessionrec.DataSourceParams(**params)).read_training(_ctx(port))
        want = jsess.SessionDataSource(jsess.DataSourceParams(**params)).read_training(
            JaxEngineContext(storage=jax_storage))
        assert got.sequences == want.sequences
        if min_len == 2:
            assert got.sequences["u1"][-2:] == want.sequences["u1"][-2:]  # the time tie
            assert "solo" not in got.sequences and len(got.sequences) == N_USERS

    def test_item_index_equals_jax(self):
        """String order, so "i10" comes before "i2"."""
        events = [dict(event="buy", entity_type="user", entity_id=f"u{u}",
                       target_entity_type="item", target_entity_id=item,
                       event_time=T0 + timedelta(seconds=10 * u + t), event_id=f"e{u}{t}")
                  for u in range(3) for t, item in enumerate(["i10", "i2", "x", f"i{u}"])]
        port = _fill(memory_storage(), App, Event, events)
        jax_storage = _fill(jax_memory_storage(), JaxApp, JaxEvent, events)
        td = sessionrec.SessionDataSource(
            sessionrec.DataSourceParams(app_name="SessApp")).read_training(_ctx(port))
        algo_params = dict(d_model=16, n_heads=1, n_layers=1, max_len=8, epochs=1,
                           batch_size=2)
        got = sessionrec.SeqRecAlgorithm(sessionrec.AlgorithmParams(**algo_params)).train(
            _ctx(port), td)
        jtd = jsess.SessionDataSource(jsess.DataSourceParams(app_name="SessApp")).read_training(
            JaxEngineContext(storage=jax_storage))
        want = jsess.SeqRecAlgorithm(jsess.AlgorithmParams(**algo_params, use_mesh=False)).train(
            None, jtd)
        assert got.item_index.to_dict() == want.item_index.to_dict()
        assert list(got.item_index.to_dict()) == ["i0", "i1", "i10", "i2", "x"]
        assert got.histories == want.histories
        assert got.cfg.vocab == want.cfg.vocab == 6
        assert len(got.train_run.losses) == 2 and got.device == torch.device("cpu")


class TestRunTrainEndToEnd:
    def test_train_deploy_and_query(self, stores, tmp_path):
        port, _ = stores
        outcome = run_train(variant=VARIANT, ctx=_ctx(port))
        assert outcome.status == "COMPLETED"
        assert list(outcome.stage_seconds) == ["read", "prepare", "train", "persist"]
        assert "train" in format_stage_times(outcome.stage_seconds)
        run = outcome.models[0].train_run
        assert len(run.losses) == 25 * 3 and run.losses[-1] < run.losses[0]
        checkpoint = tmp_path / f"seqrec_{outcome.instance_id}_a0"
        assert sorted(p.name for p in checkpoint.iterdir()) == ["model.json", "params.npz"]
        instance = port.get_meta_data_engine_instances().get(outcome.instance_id)
        assert (instance.status, instance.engine_id) == ("COMPLETED", "sess")

        deployed = _deploy(port, outcome.instance_id)
        assert deployed.instance == instance
        Query = sessionrec.Query
        # explicit history: ... i3 i4 i5 -> next should be i6
        result = deployed.query(Query(items=("i3", "i4", "i5"), num=3))
        assert result.item_scores and result.item_scores[0].item == "i6"
        # per-user history from training state
        assert deployed.query(Query(user="u0", num=3)).item_scores
        # the black list removes the top item
        top = result.item_scores[0].item
        rb = deployed.query(Query(items=("i3", "i4", "i5"), num=3, black_list=(top,)))
        assert rb.item_scores and all(s.item != top for s in rb.item_scores)
        # unknown user -> empty
        assert deployed.query(Query(user="nobody", num=3)).item_scores == ()

    def test_two_algorithms_save_to_numbered_directories(self, stores, tmp_path):
        port, _ = stores
        small = {"d_model": 16, "n_heads": 1, "n_layers": 1, "max_len": 8, "epochs": 1}
        variant = dict(VARIANT, algorithms=[
            {"name": "seqrec", "params": small},
            {"name": "seqrec", "params": dict(small, seed=1)}])
        outcome = run_train(variant=variant, ctx=_ctx(port))
        iid = outcome.instance_id
        assert sorted(p.name for p in tmp_path.iterdir()) == [f"seqrec_{iid}_a0",
                                                              f"seqrec_{iid}_a1"]
        deployed = _deploy(port, iid)
        assert len(deployed.models) == 2
        a, b = (m.params["item_emb"] for m in deployed.models)
        assert torch.equal(a, outcome.models[0].params["item_emb"]) and not torch.equal(a, b)

    @pytest.mark.parametrize("flag, stages", [
        ("stop_after_read", ["read"]),
        ("stop_after_prepare", ["read", "prepare"]),
    ])
    def test_stop_after(self, stores, tmp_path, monkeypatch, flag, stages):
        port, _ = stores
        monkeypatch.setattr(sessionrec.SeqRecAlgorithm, "train",
                            lambda *a: pytest.fail("trained after a stop"))
        outcome = run_train(variant=VARIANT, ctx=_ctx(port, **{flag: True}))
        assert outcome.status == "INTERRUPTED" and outcome.models == []
        assert list(outcome.stage_seconds) == stages
        assert not any(tmp_path.iterdir())
        instance = port.get_meta_data_engine_instances().get(outcome.instance_id)
        assert instance.status == "INTERRUPTED"

    def test_sanity_check_and_missing_app(self, tmp_path):
        storage = _fill(memory_storage(), App, Event, [])
        with pytest.raises(ValueError, match="no user event sequences"):
            run_train(variant=VARIANT, ctx=_ctx(storage))
        outcome = run_train(variant=VARIANT, ctx=_ctx(storage, skip_sanity_check=True,
                                                       stop_after_read=True))
        assert outcome.status == "INTERRUPTED"
        with pytest.raises(AppNotFoundError):
            run_train(variant=dict(VARIANT, datasource={"params": {"app_name": "Nope"}}),
                      ctx=_ctx(storage))
        statuses = sorted(i.status for i in
                          storage.get_meta_data_engine_instances().get_all())
        assert statuses == ["FAILED", "FAILED", "INTERRUPTED"]

    def test_model_dir_required_unless_not_saving(self, stores, tmp_path):
        """Without saving, nothing is checkpointed and the instance's blob
        holds None: the deploy retrains (on the serving algorithms)."""
        port, _ = stores
        with pytest.raises(ValueError, match="engineFactory"):
            run_train(variant={k: v for k, v in VARIANT.items() if k != "engineFactory"},
                      ctx=_ctx(port))
        small = dict(VARIANT, algorithms=[{"name": "seqrec", "params": {
            "d_model": 16, "n_heads": 1, "n_layers": 1, "max_len": 8, "epochs": 1}}])
        outcome = run_train(variant=small, ctx=_ctx(port, save_model=False))
        assert outcome.status == "COMPLETED" and outcome.models[0].train_run.losses
        assert "persist" in outcome.stage_seconds and not any(tmp_path.iterdir())
        deployed = _deploy(port, outcome.instance_id)
        assert deployed.models[0].train_run.losses and not any(tmp_path.iterdir())

    def test_context_defaults_to_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            EngineContext(storage=memory_storage())
        assert EngineContext(device="cpu").device == torch.device("cpu")


class TestBindingAndStorage:
    @pytest.mark.parametrize("variant", [
        VARIANT,
        {"algorithms": [{"name": "seqrec", "params": {"dModel": 48, "useMesh": False}}]},
        {},
    ], ids=["template_test_variant", "camel_case", "all_defaults"])
    def test_params_from_variant_json_equals_jax(self, variant):
        got = sessionrec.engine_factory().params_from_variant_json(variant)
        want = jsess.engine_factory().params_from_variant_json(variant)
        assert [(n, dataclasses.asdict(p)) for n, p in got.algorithm_params_list] == \
            [(n, dataclasses.asdict(p)) for n, p in want.algorithm_params_list]
        assert dataclasses.asdict(got.data_source_params[1]) == \
            dataclasses.asdict(want.data_source_params[1])
        assert isinstance(got, EngineParams)

    def test_variant_rejects_unknown_names(self):
        with pytest.raises(ValueError, match="unknown component"):
            sessionrec.engine_factory().params_from_variant_json(
                {"algorithms": [{"name": "als"}]})
        with pytest.raises(ValueError, match="Unknown parameter"):
            sessionrec.engine_factory().params_from_variant_json(
                {"algorithms": [{"name": "seqrec", "params": {"dmodel": 2}}]})

    @pytest.mark.parametrize("env, want", [
        ({"PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
          "PIO_STORAGE_SOURCES_DB_PATH": "{tmp}/db.sqlite",
          "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
          "PIO_STORAGE_SOURCES_FS_PATH": "{tmp}/models",
          "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
          "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
          "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "DB"}, "db.sqlite"),
        ({"PIO_FS_BASEDIR": "{tmp}"}, "pio.sqlite"),
        ({"PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
          "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
          "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
          "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "NOPE"}, "Undefined"),
    ], ids=["sqlite", "nothing_configured", "undefined_source"])
    def test_only_memory_sources(self, env, want, tmp_path):
        """sqlite + localfs are ported (configured, or the JAX package's
        default under PIO_FS_BASEDIR); an undefined source raises."""
        storage = Storage({k: v.format(tmp=tmp_path) for k, v in env.items()})
        if want == "Undefined":
            with pytest.raises(StorageError, match=want):
                storage.get_events()
            return
        assert storage.get_events().init(1) and (tmp_path / want).exists()

    def test_memory_store_find_filters_sorts_and_limits(self):
        storage = memory_storage()
        app_id = storage.get_meta_data_apps().insert(App(0, "A"))
        assert storage.get_meta_data_apps().insert(App(0, "A")) is None
        ch = storage.get_meta_data_channels().insert(Channel(0, "web", app_id))
        events = storage.get_events()
        events.insert(Event("view", "user", "u", "item", "b", event_time=T0, event_id="2"),
                      app_id, ch)
        events.insert(Event("view", "user", "u", "item", "a", event_time=T0, event_id="1"),
                      app_id, ch)
        events.insert(Event("buy", "user", "v", "item", "c", event_time=T0 - timedelta(1)),
                      app_id, ch)
        store = EventStore(storage)
        assert [e.event_id for e in store.find("A", "web")][1:] == ["1", "2"]
        assert [e.target_entity_id for e in store.find("A", "web", event_names=["view"],
                                                       reversed=True, limit=1)] == ["b"]
        assert list(store.find("A")) == []
        with pytest.raises(AppNotFoundError):
            store.find("A", "mobile")

    @pytest.mark.parametrize("fields", [
        dict(event="view", entity_type="user", entity_id="u"),
        dict(event="", entity_type="user", entity_id="u"),
        dict(event="$set", entity_type="user", entity_id="u", target_entity_type="item",
             target_entity_id="i"),
        dict(event="view", entity_type="pio_x", entity_id="u"),
        dict(event="view", entity_type="user", entity_id="u", target_entity_type="item"),
    ])
    def test_event_copy_validates_as_jax(self, fields):
        naive = datetime(2026, 3, 1, 12)
        port_event = Event(**fields, event_time=naive)
        assert port_event.event_time.tzinfo is timezone.utc
        try:
            JaxEventValidation.validate(JaxEvent(**fields))
            EventValidation.validate(port_event)
        except ValueError as e:
            with pytest.raises(EventValidationError, match=re.escape(str(e))):
                EventValidation.validate(port_event)
