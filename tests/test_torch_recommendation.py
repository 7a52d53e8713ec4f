"""The port's ALS model and recommendation template
(``predictionio_tpu_torch/models/als.py``, ``utils/checkpoint.py``,
``templates/recommendation.py``) against the JAX package's on the CPU:
the same factors answer the same queries, each package loads the other's
saved model, and the same events train through ``run_train`` to a
deployed engine whose HTTP answers match JAX's template trained on them
(the port's initial item factors patched to JAX's draw).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import urllib.request
from datetime import datetime, timedelta, timezone

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.core.datamap import DataMap as JaxDataMap
from predictionio_tpu.core.event import Event as JaxEvent
from predictionio_tpu.models import als as jmodels
from predictionio_tpu.storage.base import App as JaxApp
from predictionio_tpu.templates import recommendation as jrec
from predictionio_tpu.utils import checkpoint as jckpt
from predictionio_tpu.utils.bimap import BiMap as JaxBiMap
from predictionio_tpu.utils.bimap import EntityIdIxMap as JaxEntityIdIxMap
from predictionio_tpu.utils.testing import memory_storage as jax_memory_storage
from predictionio_tpu.workflow.context import EngineContext as JaxEngineContext
from predictionio_tpu_torch.api.engine_server import create_engine_server
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.models import als as pmodels
from predictionio_tpu_torch.storage.base import App
from predictionio_tpu_torch.storage.registry import memory_storage
from predictionio_tpu_torch.templates import recommendation as prec
from predictionio_tpu_torch.utils import checkpoint as pckpt
from predictionio_tpu_torch.utils.bimap import BiMap, EntityIdIxMap
from predictionio_tpu_torch.workflow.context import EngineContext
from predictionio_tpu_torch.workflow.deploy import ServerConfig, load_deployed_engine
from predictionio_tpu_torch.workflow.train import run_train

FACTORY = "predictionio_tpu_torch.templates.recommendation.engine_factory"
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
#: scores of the same model on both sides: f32 products in another
#: summation order
SCORE_TOL = 1e-5


# ---------------------------------------------------------------------------
# ALSModel on the same factors
# ---------------------------------------------------------------------------


def _factors(seed=0, users=30, items=1100, rank=6):
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((users, rank)).astype(np.float32)
    I = rng.standard_normal((items, rank)).astype(np.float32)
    seen = {u: np.sort(rng.choice(items, int(rng.integers(0, 40)), replace=False)
                       ).astype(np.int32) for u in range(users)}
    seen[3] = np.sort(rng.choice(items, 700, replace=False)).astype(np.int32)  # > 512
    return U, I, seen


def _models(seed=0, **kw):
    """(port ALSModel on the CPU, JAX ALSModel) of the same factors."""
    U, I, seen = _factors(seed, **kw)
    uids = {f"u{i}": i for i in range(U.shape[0])}
    iids = {f"i{i}": i for i in range(I.shape[0])}
    port = pmodels.ALSModel.from_jax(U, I, uids, iids, seen, device="cpu")
    jax_model = jmodels.ALSModel(
        rank=U.shape[1], user_factors=jnp.asarray(U), item_factors=jnp.asarray(I),
        user_ids=JaxEntityIdIxMap(JaxBiMap(uids)), item_ids=JaxEntityIdIxMap(JaxBiMap(iids)),
        seen_by_user=seen)
    return port, jax_model


def _same_ranking(got, want, tol=SCORE_TOL):
    """Two [(item, score)] lists: as long, scores within ``tol`` in order,
    items equal but for near-ties."""
    assert len(got) == len(want)
    gs, ws = [s for _, s in got], [s for _, s in want]
    np.testing.assert_allclose(gs, ws, rtol=tol, atol=tol)
    gi, wi = dict(got), dict(want)
    for item in set(gi) ^ set(wi):
        score = gi.get(item, wi.get(item))
        assert abs(score - ws[-1]) <= 2 * tol, item


class TestALSModel:
    @pytest.mark.parametrize("user, num, exclude_seen", [
        ("u0", 10, True), ("u1", 100, True), ("u2", 5, False), ("u3", 20, True),
        ("u3", 1000, True), ("nobody", 10, True),
    ])
    def test_recommend_equals_jax(self, user, num, exclude_seen):
        port, jax_model = _models()
        got = port.recommend(user, num, exclude_seen=exclude_seen)
        want = jax_model.recommend(user, num, exclude_seen=exclude_seen)
        _same_ranking(got, want)
        if exclude_seen and user in port.user_ids:
            seen = set(port.seen_by_user[port.user_ids[user]].tolist())
            assert not {port.item_ids[i] for i, _ in got} & seen

    def test_seen_overflow_folds_into_allow(self):
        """u3 has 700 seen items: past the 512-slot pad they must still be
        hidden, with and without a caller's allow vector."""
        port, jax_model = _models()
        seen = set(port.seen_by_user[3].tolist())
        allow = np.ones(1100, np.float32)
        allow[:50] = 0.0
        for a in (None, allow):
            got = port.recommend("u3", 400, allow=a)
            eligible = set(range(1100)) - seen - (set() if a is None else set(range(50)))
            assert len(got) == min(400, len(eligible))
            assert {port.item_ids[i] for i, _ in got} <= eligible
            _same_ranking(got, jax_model.recommend("u3", 400, allow=a))
        assert allow[:50].sum() == 0 and allow[50:].all()   # the caller's vector untouched

    @pytest.mark.parametrize("query", [["i1"], ["i1", "i5", "i9"], ["i2", "missing"],
                                       [f"i{j}" for j in range(600)], ["missing"]])
    def test_similar_equals_jax(self, query):
        port, jax_model = _models()
        got = port.similar(query, 10)
        _same_ranking(got, jax_model.similar(query, 10))
        assert not {i for i, _ in got} & set(query[:512])

    def test_allow_vector_and_batch_topk_equal_jax(self):
        port, jax_model = _models()
        allow = jmodels.build_allow_vector(jax_model.item_ids, white_list=["i1", "i2", "i3"],
                                           black_list=["i2"])
        _same_ranking(port.recommend("u0", 10, allow=allow),
                      jax_model.recommend("u0", 10, allow=allow))
        uixs = np.asarray([0, 1, 2, 4], np.int32)
        cols = np.zeros((4, 32), np.int32)
        mask = np.zeros((4, 32), np.float32)
        cols[0, :3], mask[0, :3] = [5, 6, 7], 1.0
        gv, gi = port.batch_topk(uixs, cols, mask, None, 10)
        wv, wi = jax_model.batch_topk(uixs, cols, mask, None, 10)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=SCORE_TOL, atol=SCORE_TOL)
        assert not set(gi[0].tolist()) & {5, 6, 7}

    def test_predict_rating_equals_jax(self):
        port, jax_model = _models()
        for u, i in (("u0", "i0"), ("u7", "i1099"), ("u0", "nope"), ("nobody", "i0")):
            got, want = port.predict_rating(u, i), jax_model.predict_rating(u, i)
            assert (got is None) == (want is None)
            if got is not None:
                assert abs(got - want) < SCORE_TOL * max(1.0, abs(want))

    @pytest.mark.parametrize("rules", [
        {}, {"white_list": ["i1", "i2", "zz"]}, {"white_list": []}, {"black_list": ["i3"]},
        {"white_list": ["i1", "i3"], "black_list": ["i3"]},
        {"categories": ["a"], "category_map": {"i1": ["a"], "i2": ["b"]}},
        {"categories": ["a"]}, {"categories": ["b"], "white_list": ["i2", "i4"],
                                "category_map": {"i2": ["b"], "i4": ["a"]}},
    ])
    def test_build_allow_vector_equals_jax(self, rules):
        ids = {f"i{i}": i for i in range(6)}
        got = pmodels.build_allow_vector(EntityIdIxMap(BiMap(ids)), **rules)
        want = jmodels.build_allow_vector(JaxEntityIdIxMap(JaxBiMap(ids)), **rules)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)

    def test_later_slices_raise_and_brute_is_the_retrieval(self):
        """Brute force is the default retrieval; ANN (ROADMAP.md queue 1
        item 10) and the online overlay (item 11) are ported now and
        covered by tests/test_torch_ann.py and tests/test_torch_online.py."""
        port, jax_model = _models()
        port.configure_retrieval("brute")
        assert port.retrieval == "brute" and not port.ann_enabled
        port.configure_retrieval("ann", nprobe=4)
        jax_model.configure_retrieval("ann", nprobe=4)
        assert port.ann_enabled and port.ann_index.nlist == jax_model.ann_index.nlist
        for u in ("u0", "u3"):
            _same_ranking(port.recommend(u, 30), jax_model.recommend(u, 30))
        assert port.needs_online_path("u0") is False
        port.set_online_overlay(None)
        assert port.online_delta("u0") is None


class TestPersistence:
    def test_port_loads_a_jax_saved_model(self, tmp_path, monkeypatch):
        """JAX's npz backend (its orbax default needs JAX to read)."""
        monkeypatch.setattr(jckpt, "_ocp", lambda: None)
        monkeypatch.setenv("PIO_SERVING_ANN_BUILD", "0")
        _, jax_model = _models()
        jax_model.save(str(tmp_path))
        assert not (tmp_path / "ann").exists()
        port = pmodels.ALSModel.load(str(tmp_path), device="cpu")
        np.testing.assert_array_equal(port.item_factors.numpy(),
                                      np.asarray(jax_model.item_factors))
        assert port.user_ids.id_to_ix == BiMap(jax_model.user_ids.id_to_ix.to_dict())
        for u in ("u0", "u3"):
            _same_ranking(port.recommend(u, 50), jax_model.recommend(u, 50))

    def test_port_ignores_a_jax_ann_index(self, tmp_path, monkeypatch):
        """A JAX model saved with its IVF index (1,100 items >= the build
        threshold): the port serves brute force, JAX's default retrieval."""
        monkeypatch.setattr(jckpt, "_ocp", lambda: None)
        monkeypatch.delenv("PIO_SERVING_ANN_BUILD", raising=False)
        _, jax_model = _models()
        jax_model.save(str(tmp_path))
        assert (tmp_path / "ann" / "checkpoint_meta.json").exists()
        port = pmodels.ALSModel.load(str(tmp_path), device="cpu")
        reloaded = jmodels.ALSModel.load(str(tmp_path))
        assert reloaded.retrieval == "brute"
        _same_ranking(port.recommend("u0", 20), reloaded.recommend("u0", 20))

    def test_jax_loads_a_port_saved_model(self, tmp_path):
        port, _ = _models(seed=1)
        port.save(str(tmp_path))
        # 1,100 items: the index is built at persist time, as JAX builds it
        assert json.loads((tmp_path / "model.json").read_text())["ann"] == {
            "nlist": port.ann_index.nlist, "n_items": 1100}
        jax_model = jmodels.ALSModel.load(str(tmp_path))
        np.testing.assert_array_equal(jax_model.ann_index.flat_items,
                                      port.ann_index.flat_items)
        np.testing.assert_array_equal(np.asarray(jax_model.user_factors),
                                      port.user_factors.numpy())
        assert jax_model.seen_by_user.keys() == port.seen_by_user.keys()
        for u in ("u0", "u3", "nobody"):
            _same_ranking(port.recommend(u, 30), jax_model.recommend(u, 30))
        back = pmodels.ALSModel.load(str(tmp_path), device="cpu")
        assert torch.equal(back.item_factors, port.item_factors) and back.rank == port.rank

    def test_checkpoint_format_and_integrity(self, tmp_path):
        a = {"user": np.arange(6, dtype=np.float32).reshape(2, 3)}
        assert pckpt.save_sharded(str(tmp_path), a) == "npz"
        first = sorted(os.listdir(tmp_path))
        assert first[0].startswith("arrays-") and first[1] == "checkpoint_meta.json"
        # JAX reads it, and a new generation replaces the old payload
        np.testing.assert_array_equal(jckpt.load_sharded(str(tmp_path))["user"], a["user"])
        pckpt.save_sharded(str(tmp_path), {"user": a["user"] + 1})
        assert len([f for f in os.listdir(tmp_path) if f.startswith("arrays-")]) == 1
        # a flipped byte in the payload fails the checksum
        payload = next(tmp_path.glob("arrays-*.npz"))
        raw = bytearray(payload.read_bytes())
        raw[-200] ^= 0xFF
        payload.write_bytes(bytes(raw))
        with pytest.raises(pckpt.CheckpointCorruptError):
            pckpt.load_sharded(str(tmp_path))
        payload.unlink()
        with pytest.raises(pckpt.CheckpointCorruptError, match="missing"):
            pckpt.load_sharded(str(tmp_path))

    def test_orbax_checkpoint_needs_jax(self, tmp_path):
        (tmp_path / "orbax").mkdir()
        with pytest.raises(RuntimeError, match="needs JAX"):
            pckpt.load_sharded(str(tmp_path))
        (tmp_path / "checkpoint_meta.json").write_text('{"backend": "orbax"}')
        with pytest.raises(RuntimeError, match="orbax"):
            pckpt.load_sharded(str(tmp_path))

    def test_load_defaults_to_cuda(self, tmp_path, monkeypatch):
        port, _ = _models()
        port.save(str(tmp_path))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            pmodels.ALSModel.load(str(tmp_path))


# ---------------------------------------------------------------------------
# The template: events → run_train → deploy → HTTP
# ---------------------------------------------------------------------------


def _events():
    """Two taste clusters (even users like even items), as
    tests/test_recommendation_templates.py makes them, plus what the data
    source must drop or keep: a rate with no rating, one with a
    malformed rating, one rating given as a string, a duplicate pair, a
    view (another event name) and an event with no target."""
    rng = np.random.default_rng(0)
    out = []
    n = 0

    def add(event, user, item=None, props=None):
        nonlocal n
        out.append(dict(event=event, entity_type="user", entity_id=user,
                        target_entity_type="item" if item else None, target_entity_id=item,
                        properties=props or {}, event_time=T0 + timedelta(seconds=n),
                        event_id=f"e{n:05d}"))
        n += 1

    for u in range(24):
        for i in range(16):
            if i % 2 == u % 2 and rng.random() < 0.8:
                add("rate", f"u{u}", f"i{i}", {"rating": 5.0})
            elif rng.random() < 0.1:
                add("rate", f"u{u}", f"i{i}", {"rating": 1.0})
        if u % 3 == 0:
            add("buy", f"u{u}", f"i{(u % 2) + 2}")
    add("rate", "u1", "i1", {"rating": 4.0})          # a duplicate of a likely pair
    add("rate", "u1", "x1")                           # no rating: dropped
    add("rate", "u2", "x2", {"rating": "bad"})        # malformed: dropped
    add("rate", "u2", "i4", {"rating": "4.5"})        # a string that parses
    add("view", "u4", "i4")                           # another event name
    add("rate", "u5")                                 # no target
    return out


def _fill(storage, app_cls, event_cls, datamap_cls, events):
    app_id = storage.get_meta_data_apps().insert(app_cls(0, "RecApp"))
    store = storage.get_events()
    store.init(app_id)
    store.insert_batch([event_cls(**{**e, "properties": datamap_cls(e["properties"])})
                        for e in events], app_id)
    return storage


@pytest.fixture
def stores():
    events = _events()
    return (_fill(memory_storage(), App, Event, DataMap, events),
            _fill(jax_memory_storage(), JaxApp, JaxEvent, JaxDataMap, events))


VARIANT = {
    "engineFactory": FACTORY,
    "datasource": {"params": {"appName": "RecApp"}},
    "algorithms": [{"name": "als", "params": {"rank": 8, "numIterations": 8,
                                              "lambda": 0.05, "seed": 1}}],
}


def _ctx(storage):
    return EngineContext(storage=storage, device="cpu")


@pytest.fixture(autouse=True)
def _model_dir(tmp_path, monkeypatch):
    """Checkpoints land under the test's own directory."""
    monkeypatch.setenv("PIO_MODEL_DIR", str(tmp_path))


def _jax_train(jax_storage, variant=VARIANT):
    """JAX's template on the same events: read → prepare → train."""
    engine = jrec.engine_factory()
    ep = engine.params_from_variant_json(variant)
    ds, prep, algos, _ = engine.make_components(ep)
    algo = algos[0]
    algo.params = dataclasses.replace(algo.params, use_mesh=False)
    ctx = JaxEngineContext(storage=jax_storage)
    return algo, algo.train(ctx, prep.prepare(ctx, ds.read_training(ctx)))


def _post(port: int, body: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/queries.json",
                                 data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


class TestTemplate:
    def test_ratings_equal_jax(self, stores):
        port_storage, jax_storage = stores
        got = prec.RecommendationDataSource(prec.DataSourceParams(app_name="RecApp")
                                            ).read_training(_ctx(port_storage))
        want = jrec.RecommendationDataSource(jrec.DataSourceParams(app_name="RecApp")
                                             ).read_training(JaxEngineContext(storage=jax_storage))
        triples = lambda td: sorted(zip(td.users.tolist(), td.items.tolist(),
                                        td.ratings.tolist()))
        assert triples(got) == triples(want)
        assert ("u2", "i4", 4.5) in triples(got) and triples(got).count(("u1", "i1", 4.0)) == 1
        assert not {"x1", "x2"} & set(got.items.tolist())
        assert got.ratings.dtype == np.float32

    def test_train_deploy_and_http_match_jax(self, stores, tmp_path, monkeypatch):
        """run_train → load_deployed_engine → the engine server, against
        JAX's template on the same events, the port's initial item
        factors set to JAX's draw. Both templates' ``als_train`` are
        patched to the f32 build, so that the pipelines are compared and
        not bf16 summation orders (test_torch_als.py holds the bf16
        route): scores within 1e-3 (measured ~1e-5), items equal but for
        near-ties."""
        port_storage, jax_storage = stores
        monkeypatch.setattr(jrec, "als_train",
                            functools.partial(jrec.als_train, matmul_dtype="float32"))
        jalgo, jmodel = _jax_train(jax_storage)
        jax_item0 = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (16, 8),
                                                 dtype=jnp.float32) / jnp.sqrt(jnp.float32(8)))
        real = prec.als_train

        def with_jax_item0(coo, **kw):
            inv = {ix: iid for iid, ix in prepared_ids["item"].items()}
            order = [jmodel.item_ids[inv[ix]] for ix in range(coo.num_cols)]
            return real(coo, item0=jax_item0[order], matmul_dtype="float32", **kw)

        prepared_ids = {}
        real_prepare = prec.ALSPreparator.prepare

        def spy_prepare(self, ctx, td):
            pd = real_prepare(self, ctx, td)
            prepared_ids["item"] = pd.item_ids.id_to_ix.to_dict()
            return pd

        monkeypatch.setattr(prec.ALSPreparator, "prepare", spy_prepare)
        monkeypatch.setattr(prec, "als_train", with_jax_item0)
        outcome = run_train(variant=VARIANT, ctx=_ctx(port_storage))
        assert outcome.status == "COMPLETED"
        assert list(outcome.stage_seconds) == ["read", "prepare", "train", "persist"]

        server = create_engine_server(port_storage, ServerConfig(
            ip="127.0.0.1", port=0, device="cpu")).start()
        try:
            for body in ({"user": "u0", "num": 5}, {"user": "u1", "num": 10},
                         {"user": "u4", "num": 3, "blackList": ["i4", "i6"]},
                         {"user": "u7", "num": 10, "whiteList": ["i1", "i2", "i3", "i9"]},
                         {"user": "stranger", "num": 5}):
                doc = _post(server.port, body)
                got = [(s["item"], s["score"]) for s in doc["itemScores"]]
                q = jrec.Query(user=body["user"], num=body["num"],
                               white_list=tuple(body["whiteList"]) if "whiteList" in body else None,
                               black_list=tuple(body.get("blackList", ())) or None)
                want = [(s.item, s.score) for s in jalgo.predict(jmodel, q).item_scores]
                _same_ranking(got, want, tol=1e-3)
        finally:
            server.stop()

    def test_batch_predict_equals_predict_and_the_rules_hold(self, stores, tmp_path):
        port_storage, _ = stores
        outcome = run_train(variant=VARIANT, ctx=_ctx(port_storage))
        deployed = load_deployed_engine(port_storage, ServerConfig(
            engine_instance_id=outcome.instance_id, device="cpu"))
        model = deployed.models[0]
        Q = prec.Query
        queries = [Q(user=f"u{u}", num=n) for u, n in zip(range(24), [3, 5, 10, 16] * 6)]
        queries += [Q(user="stranger"), Q(user="u0", num=5, black_list=("i4",)),
                    Q(user="u1", num=5, white_list=("i1", "i3", "i8")),
                    Q(user="u2", num=5, white_list=())]
        batched = deployed.query_batch(queries)
        for q, got in zip(queries, batched):
            want = deployed.query(q)
            _same_ranking([(s.item, s.score) for s in got.item_scores],
                          [(s.item, s.score) for s in want.item_scores])
            seen = set(model.seen_by_user.get(model.user_ids.get(q.user), ()))
            items = [s.item for s in got.item_scores]
            assert not {model.item_ids[i] for i in items} & {int(s) for s in seen}
            if q.black_list:
                assert not set(items) & set(q.black_list)
            if q.white_list is not None:
                assert set(items) <= set(q.white_list)
        assert batched[-4].item_scores == () and batched[-1].item_scores == ()
        # u0 likes even items: its first pick is even
        assert int(batched[0].item_scores[0].item[1:]) % 2 == 0

    def test_params_bind_as_jax(self):
        variant = {"datasource": {"params": {"appName": "A", "buyRating": 3.0}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": 4, "numIterations": 3, "lambda": 0.2, "useMesh": False,
                       "implicitPrefs": True, "alpha": 2.0}}]}
        got = prec.engine_factory().params_from_variant_json(variant)
        want = jrec.engine_factory().params_from_variant_json(variant)
        assert [(n, dataclasses.asdict(p)) for n, p in got.algorithm_params_list] == \
            [(n, dataclasses.asdict(p)) for n, p in want.algorithm_params_list]
        assert dataclasses.asdict(got.data_source_params[1]) == \
            dataclasses.asdict(want.data_source_params[1])
        assert got.algorithm_params_list[0][1].lambda_ == 0.2

    def test_evaluation_sharding_and_sanity_are_refused(self, stores, tmp_path, monkeypatch):
        port_storage, _ = stores
        # evaluation is ported (tests/test_torch_recommendation_eval.py): eval_k
        # folds, and none asked for raises as in the JAX template
        ds = prec.RecommendationDataSource(prec.DataSourceParams(app_name="RecApp", eval_k=2))
        assert [ei for _, ei, _ in ds.read_eval(_ctx(port_storage))] == [{"fold": 0},
                                                                          {"fold": 1}]
        with pytest.raises(ValueError):
            prec.RecommendationDataSource(prec.DataSourceParams(app_name="RecApp")).read_eval(
                _ctx(port_storage))
        monkeypatch.setenv("PIO_TRAIN_SHARD_FACTORS", "1")
        with pytest.raises(NotImplementedError, match="item 15"):
            run_train(variant=VARIANT, ctx=_ctx(port_storage))
        monkeypatch.delenv("PIO_TRAIN_SHARD_FACTORS")
        empty = memory_storage()
        empty.get_meta_data_apps().insert(App(0, "RecApp"))
        with pytest.raises(ValueError, match="ratings are empty"):
            run_train(variant=VARIANT, ctx=_ctx(empty))

    def test_implicit_training_equals_jax(self, stores):
        """implicitPrefs through both templates, the port started from
        JAX's draw: the same factor tables within 5e-2 relative (bf16
        build; measured ~3e-3)."""
        port_storage, jax_storage = stores
        variant = {**VARIANT, "algorithms": [{"name": "als", "params": {
            "rank": 4, "numIterations": 4, "lambda": 0.1, "seed": 2,
            "implicitPrefs": True, "alpha": 2.0}}]}
        _, jmodel = _jax_train(jax_storage, variant)
        engine = prec.engine_factory()
        ds, prep, algos, _ = engine.make_components(engine.params_from_variant_json(variant))
        pd = prep.prepare(None, ds.read_training(_ctx(port_storage)))
        item0 = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (16, 4), dtype=jnp.float32)
                           / jnp.sqrt(jnp.float32(4)))
        order = [jmodel.item_ids[pd.item_ids.inverse[ix]] for ix in range(16)]
        p = algos[0].params
        factors = prec.als_train(pd.coo, rank=4, iterations=4, lam=p.lambda_, implicit=True,
                                 alpha=p.alpha, item0=item0[order], device="cpu")
        want = np.asarray(jmodel.item_factors)[order]
        got = factors.item.numpy()
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 5e-2
