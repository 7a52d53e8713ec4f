"""The port's freshness plane (``online/``, the online half of
``models/als.py`` and the engine server's wiring) beside the JAX
package's, on the CPU (lane: tests/test_online_freshness.py and
tests/test_ann.py::TestOnlineOverlayNeutrality).

No wall-clock windows: both fold-in services are started with an
interval they never reach, and each cycle is driven by calling
``tick()``. Both tail one sqlite file (the store both packages share),
with the same factors, the same events and the same start cursor.

- fold-in math and the overlay (fencing, LRU, the delta matrix): the
  same calls give the same results in both;
- the follower: both packages' pages and cursors over one file;
- serving after a fold: the port's ``recommend`` returns JAX's ids in
  JAX's order for a folded user, a cold-start user, a new item and an
  unfolded user, under brute force and under ANN;
- a reload fences the overlay and refolds against the new model;
- a fold invalidates only the folded user's result-cache entries.
"""

from __future__ import annotations

import json
from datetime import datetime, timedelta, timezone

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.api import engine_server as jserver_mod
from predictionio_tpu.controller import FirstServing as JaxFirstServing
from predictionio_tpu.models import als as jmodels
from predictionio_tpu.obs import registry as jregistry
from predictionio_tpu.obs import trace as jtrace
from predictionio_tpu.online import foldin as jfoldin
from predictionio_tpu.online import follower as jfollower
from predictionio_tpu.online import overlay as joverlay
from predictionio_tpu.online import service as jservice
from predictionio_tpu.storage.base import EngineInstance as JaxEngineInstance
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.templates import recommendation as jrec
from predictionio_tpu.utils.bimap import BiMap as JaxBiMap
from predictionio_tpu.utils.bimap import EntityIdIxMap as JaxEntityIdIxMap
from predictionio_tpu.workflow.deploy import DeployedEngine as JaxDeployedEngine
from predictionio_tpu.workflow.deploy import ServerConfig as JaxServerConfig
from predictionio_tpu_torch.api import engine_server as pserver_mod
from predictionio_tpu_torch.controller import FirstServing, PersistentModelManifest
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.models import als as pmodels
from predictionio_tpu_torch.obs import registry as pregistry
from predictionio_tpu_torch.obs import trace as ptrace
from predictionio_tpu_torch.online import foldin, follower, overlay, service
from predictionio_tpu_torch.serving.result_cache import ResultCache
from predictionio_tpu_torch.storage.base import App, EngineInstance
from predictionio_tpu_torch.storage.registry import Storage, memory_storage
from predictionio_tpu_torch.templates import recommendation as prec
from predictionio_tpu_torch.workflow.deploy import DeployedEngine, ServerConfig
from predictionio_tpu_torch.workflow.persistence import save_models

pytestmark = pytest.mark.online

RANK = 8
LAM = 0.05
N_USERS, N_ITEMS = 48, 1200
APP = "OnApp"
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
#: the services tail from here: the base history lies before it
START = T0 + timedelta(days=1)
SCORE_TOL = 1e-5
DS_PARAMS = json.dumps({"name": "", "params": {"appName": APP}})
ALGO_PARAMS = json.dumps([{"name": "als", "params": {"rank": RANK, "lambda": LAM}}])


def _us(t: datetime) -> int:
    return int(t.timestamp() * 1_000_000)


def _event(event, user, item, props=None, at=None):
    return Event(event=event, entity_type="user", entity_id=user,
                 target_entity_type="item", target_entity_id=item,
                 properties=DataMap(props or {}), **({"event_time": at} if at else {}))


def _factors(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    users = (rng.standard_normal((N_USERS, RANK)) * scale).astype(np.float32)
    items = rng.standard_normal((N_ITEMS, RANK)).astype(np.float32)
    return users, items


def _seen(seed):
    rng = np.random.default_rng(seed + 100)
    return {u: np.sort(rng.choice(N_ITEMS, 6, replace=False)).astype(np.int32)
            for u in range(N_USERS)}


def _port_model(users, items, seen):
    return pmodels.ALSModel.from_jax(users, items, {f"u{i}": i for i in range(N_USERS)},
                                     {f"i{i}": i for i in range(N_ITEMS)}, seen,
                                     device="cpu")


def _jax_model(users, items, seen):
    return jmodels.ALSModel(
        rank=RANK, user_factors=jnp.asarray(users), item_factors=jnp.asarray(items),
        user_ids=JaxEntityIdIxMap(JaxBiMap({f"u{i}": i for i in range(N_USERS)})),
        item_ids=JaxEntityIdIxMap(JaxBiMap({f"i{i}": i for i in range(N_ITEMS)})),
        seen_by_user=seen)


def _instance(cls, factory):
    return cls(id="inst", status="COMPLETED", start_time=T0, completion_time=T0,
               engine_id="e", engine_version="1", engine_variant="e", engine_factory=factory,
               data_source_params=DS_PARAMS, algorithms_params=ALGO_PARAMS)


def _jax_deployed(seed=0, scale=1.0):
    users, items = _factors(seed, scale)
    algo = jrec.ALSAlgorithm(jrec.ALSAlgorithmParams(rank=RANK, lambda_=LAM))
    return JaxDeployedEngine(
        jrec.engine_factory(), _instance(JaxEngineInstance, "jax"), [algo],
        JaxFirstServing(), [_jax_model(users, items, _seen(seed))])


def _port_deployed(seed=0, scale=1.0):
    users, items = _factors(seed, scale)
    algo = prec.ALSAlgorithm(prec.ALSAlgorithmParams(rank=RANK, lambda_=LAM))
    return DeployedEngine(prec.engine_factory(), "inst", [algo], FirstServing(),
                          [_port_model(users, items, _seen(seed))], torch.device("cpu"),
                          _instance(EngineInstance, prec.__name__))


@pytest.fixture
def store(tmp_path):
    """(JAX storage, port storage, app id) over one sqlite file, holding a
    base history dated before START: every user rated six items."""
    env = {"PIO_FS_BASEDIR": str(tmp_path / "store")}
    pstorage = Storage(env)
    app_id = pstorage.get_meta_data_apps().insert(App(0, APP))
    events = pstorage.get_events()
    events.init(app_id)
    rng = np.random.default_rng(7)
    history = []
    for u in range(N_USERS):
        for j, i in enumerate(_seen(0)[u]):
            history.append(_event("rate", f"u{u}", f"i{i}",
                                  {"rating": float(rng.integers(1, 6))},
                                  at=T0 + timedelta(minutes=u, seconds=j)))
    events.insert_batch(history, app_id)
    return JaxStorage(env), pstorage, app_id


class _Pair:
    """The JAX and the port fold-in service over one store, each bound to
    its own deployed engine; ``gen`` is the shared model generation."""

    def __init__(self, store):
        self.jstorage, self.pstorage, self.app_id = store
        self.gen = 0
        self.jdep, self.pdep = _jax_deployed(), _port_deployed()
        self.jsvc = jservice.OnlineFoldIn(
            storage=self.jstorage, deployed_fn=lambda: self.jdep,
            generation_fn=lambda: self.gen, interval_s=3600,
            initial_cursor=jfollower.TailCursor(_us(START), ""))
        self.psvc = service.OnlineFoldIn(
            storage=self.pstorage, deployed_fn=lambda: self.pdep,
            generation_fn=lambda: self.gen, interval_s=3600,
            initial_cursor=follower.TailCursor(_us(START), ""))
        self.jsvc.start()
        self.psvc.start()
        self.n = 0

    @property
    def jmodel(self):
        return self.jdep.models[0]

    @property
    def pmodel(self):
        return self.pdep.models[0]

    def post(self, *events):
        """Insert events after START, one second apart."""
        out = []
        for ev, user, item, props in events:
            self.n += 1
            out.append(_event(ev, user, item, props, at=START + timedelta(seconds=self.n)))
        self.pstorage.get_events().insert_batch(out, self.app_id)

    def tick(self):
        got, want = self.psvc.tick(), self.jsvc.tick()
        assert got == want
        return got

    def close(self):
        self.jsvc.close()
        self.psvc.close()


@pytest.fixture
def pair(store):
    p = _Pair(store)
    yield p
    p.close()


def _same_answers(got, want, tol=SCORE_TOL):
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=tol, atol=tol)


def _same_overlays(psvc, jsvc):
    pc, jc = psvc.overlay.counters(), jsvc.overlay.counters()
    assert pc == jc
    for uid in jsvc.overlay.touched_users():
        pd, jd = psvc.overlay.user(uid), jsvc.overlay.user(uid)
        np.testing.assert_allclose(pd.vector, jd.vector, rtol=1e-6, atol=1e-6)
        assert (pd.extra_seen, pd.delta_seen, pd.folded_events, pd.event_time_us) == \
            (jd.extra_seen, jd.delta_seen, jd.folded_events, jd.event_time_us)
    jm, pm = jsvc.overlay.delta_matrix(), psvc.overlay.delta_matrix()
    assert (jm is None) == (pm is None)
    if jm is not None:
        assert pm[0] == jm[0]
        np.testing.assert_allclose(pm[1], jm[1], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# fold-in math and the overlay
# ---------------------------------------------------------------------------


class TestFoldIn:
    @pytest.mark.parametrize("implicit", [False, True])
    @pytest.mark.parametrize("n", [0, 1, 7, 40])
    def test_solves_equal_jax(self, implicit, n):
        rng = np.random.default_rng(n + 3 * implicit)
        table = rng.normal(size=(64, RANK)).astype(np.float32)
        vecs = table[:n]
        ratings = rng.uniform(-1, 5, size=n).astype(np.float32)
        gram = foldin.item_gramian(table)
        np.testing.assert_array_equal(gram, jfoldin.item_gramian(table))
        kw = dict(lam=LAM, implicit=implicit, alpha=2.0, gram=gram if implicit else None)
        for ours, theirs in ((foldin.solve_user, jfoldin.solve_user),
                             (foldin.solve_item, jfoldin.solve_item)):
            got, want = ours(vecs, ratings, **kw), theirs(vecs, ratings, **kw)
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, want)
                assert got.dtype == want.dtype == np.float32

    def test_explicit_solve_satisfies_the_normal_equations(self):
        rng = np.random.default_rng(3)
        Y = rng.normal(size=(7, RANK)).astype(np.float32)
        r = rng.uniform(1, 5, size=7).astype(np.float32)
        u = foldin.solve_user(Y, r, lam=LAM)
        A = Y.T @ Y + LAM * 7 * np.eye(RANK, dtype=np.float32)
        np.testing.assert_allclose(A @ u, r @ Y, rtol=1e-4, atol=1e-4)
        with pytest.raises(ValueError):
            foldin.solve_user(Y, r, lam=LAM, implicit=True)

    @pytest.mark.parametrize("weights", [None, [3.0, 1.0, 0.0], [0.0, 0.0, 0.0]])
    def test_popularity_prior_equals_jax(self, weights):
        table = np.asarray([[1.0, 0.0], [0.0, 1.0], [2.0, 2.0]], dtype=np.float32)
        w = None if weights is None else np.asarray(weights)
        np.testing.assert_array_equal(foldin.popularity_prior(table, w),
                                      jfoldin.popularity_prior(table, w))
        assert foldin.popularity_prior(np.zeros((0, 4), np.float32)).shape == (4,)


class TestOverlay:
    def _apply(self, ov, mod):
        """One sequence of writes and reads; returns what it saw."""
        seen = []
        vec = lambda x: np.full((RANK,), float(x), dtype=np.float32)  # noqa: E731
        seen.append(ov.put_user("u1", mod.UserDelta(vector=vec(1)), generation=5))
        ov.advance_generation(6)
        seen.append(ov.user("u1"))
        seen.append(ov.put_user("u2", mod.UserDelta(vector=vec(2)), generation=5))
        for i in range(5):
            seen.append(ov.put_user(f"v{i}", mod.UserDelta(vector=vec(i)), generation=6))
        seen.append(ov.put_item("a", mod.ItemDelta(vec(1)), generation=6))
        first = ov.delta_matrix()
        seen.append(ov.delta_matrix()[1] is first[1])
        seen.append(ov.put_item("b", mod.ItemDelta(vec(0)), generation=6))
        ids, matrix = ov.delta_matrix()
        seen += [ids, matrix.tolist(), ov.has_items(), len(ov)]
        seen.append(ov.put_item("c", mod.ItemDelta(vec(3)), generation=4))
        ov.advance_generation(3)       # forward only
        seen += [ov.generation, ov.counters(), ov.touched_users(), ov.delta_matrix()]
        return seen

    def test_fencing_lru_and_delta_matrix_equal_jax(self):
        got = self._apply(overlay.OnlineOverlay(max_users=3, generation=5), overlay)
        want = self._apply(joverlay.OnlineOverlay(max_users=3, generation=5), joverlay)
        assert got == want
        assert got[0] is True and got[1] is None and got[2] is False
        assert got[-3]["evictions"] == 2 and got[-3]["fenced"] == 2

    def test_lru_keeps_the_latest_users(self):
        ov = overlay.OnlineOverlay(max_users=2)
        for i in range(4):
            assert ov.put_user(f"u{i}", overlay.UserDelta(
                vector=np.zeros(RANK, np.float32)), generation=0)
        assert ov.user("u0") is None and ov.user("u3") is not None
        assert ov.counters()["evictions"] == 2


class TestFollower:
    def test_pages_and_cursors_equal_jax_over_one_file(self, store):
        jstorage, pstorage, app_id = store
        events = pstorage.get_events()
        events.insert_batch(
            [_event("rate", f"u{i % 5}", f"i{i % 7}", {"rating": 1.0},
                    at=START + timedelta(seconds=i // 3)) for i in range(25)]
            + [Event(event="$set", entity_type="user", entity_id="u1",
                     properties=DataMap({"a": 1}), event_time=START)], app_id)
        pf = follower.EventTailFollower(events, app_id, batch_size=4, max_rows=10)
        jf = jfollower.EventTailFollower(jstorage.get_events(), app_id, batch_size=4,
                                         max_rows=10)
        pf.cursor = follower.TailCursor(_us(START) - 1, "")
        jf.cursor = jfollower.TailCursor(_us(START) - 1, "")
        pages = 0
        while True:
            prows, pcur = pf.poll_once()
            jrows, jcur = jf.poll_once()
            assert [tuple(dataclasses_astuple(r)) for r in prows] == \
                [tuple(dataclasses_astuple(r)) for r in jrows]
            assert pcur.to_doc() == jcur.to_doc()
            assert len(prows) <= 10
            pf.commit(pcur)
            jf.commit(jcur)
            if not prows:
                break
            pages += 1
        assert pages == 3
        # every row after START, once, in the store's order
        assert sum(1 for _ in events.find(app_id)) - 6 * N_USERS == 26

    def test_cursor_store_round_trip_and_junk(self, tmp_path):
        path = str(tmp_path / "cursor.json")
        assert follower.CursorStore(path).load() is None
        follower.CursorStore(path).save(follower.TailCursor(12345, "abc"))
        assert jfollower.CursorStore(path).load() == jfollower.TailCursor(12345, "abc")
        assert follower.CursorStore(path).load() == follower.TailCursor(12345, "abc")
        with open(path, "w") as f:
            f.write("{not json")
        assert follower.CursorStore(path).load() is None

    def test_resume_refuses_limited_or_reversed_scans(self, store):
        from predictionio_tpu_torch.storage.base import EventFilter

        _, pstorage, app_id = store
        for flt in (EventFilter(limit=3), EventFilter(reversed=True)):
            with pytest.raises(ValueError):
                list(follower.resume_columnar(pstorage.get_events(), app_id, filter=flt))


def dataclasses_astuple(row):
    return (row.event, row.entity_id, row.target_entity_id, row.time_us, row.event_id,
            json.dumps(row.properties, sort_keys=True))


# ---------------------------------------------------------------------------
# serving after a fold, both packages
# ---------------------------------------------------------------------------


def _queries(pair):
    """(user, num, exclude_seen, allow) cases: a folded user, a cold-start
    user, the new item's raters, an unfolded user, a filtered query."""
    allow = np.ones((N_ITEMS,), np.float32)
    allow[::3] = 0.0
    return [("u3", 10, True, None), ("u3", 100, False, None), ("newbie", 10, True, None),
            ("u4", 10, True, None), ("u5", 20, True, None), ("u9", 10, True, None),
            ("u3", 10, True, allow), ("nobody", 10, True, None)]


def _fold_events(pair):
    pair.post(("rate", "u3", "i5", {"rating": 5.0}), ("buy", "u3", "i7", None),
              ("rate", "newbie", "i0", {"rating": 5.0}),
              ("rate", "newbie", "i2", {"rating": 4.0}),
              ("rate", "newbie", "i4", {"rating": 5.0}),
              ("rate", "u4", "fresh", {"rating": 5.0}),
              ("rate", "u5", "fresh", {"rating": 3.0}),
              ("view", "u6", "i8", None),                # not a rating event
              ("rate", "u7", "i9", {"rating": "bad"}))   # malformed: dropped


class TestObservability:
    def test_fold_trace_equals_jax(self, pair):
        """With tracing on, a folding cycle records one online.foldin
        trace of tail → solve → publish with JAX's tags; a cycle with
        nothing to fold records none."""
        logs = {}
        for name, svc, trace_mod in (("port", pair.psvc, ptrace), ("jax", pair.jsvc, jtrace)):
            logs[name] = trace_mod.TraceLog()
            svc._trace_log, svc._tracing = logs[name], True
        assert pair.tick() == 0
        _fold_events(pair)
        assert pair.tick() == 8
        docs = {name: log.snapshot() for name, log in logs.items()}
        assert len(docs["port"]) == len(docs["jax"]) == 1
        got, want = docs["port"][0], docs["jax"][0]
        assert [s["name"] for s in got["spans"]] == [s["name"] for s in want["spans"]] == [
            "tail", "solve", "publish"]
        assert (got["name"], got["service"], got["tags"]) == (
            want["name"], want["service"], want["tags"])
        assert got["tags"] == {"events": 8, "users": 5, "items": 1, "generation": 0}

    def test_online_collector_equals_jax(self, pair):
        _fold_events(pair)
        pair.tick()
        families = []
        for registry_mod, svc in ((pregistry, pair.psvc), (jregistry, pair.jsvc)):
            metrics = registry_mod.online_collector(svc)()
            families.append({m.name: (m.kind, [labels for labels, _ in m.samples])
                             for m in metrics})
            values = {m.name: m.samples[0][1] for m in metrics
                      if m.name != "pio_online_freshness_lag_seconds"}
            families.append(values)
        assert families[0] == families[2] and families[1] == families[3]
        assert families[1]["pio_online_folded_events_total"] == 8


class TestServingAfterFold:
    @pytest.mark.parametrize("retrieval", ["brute", "ann"])
    def test_recommend_equals_jax(self, pair, retrieval):
        pair.pmodel.configure_retrieval(retrieval)
        pair.jmodel.configure_retrieval(retrieval)
        assert pair.pmodel.ann_enabled == pair.jmodel.ann_enabled == (retrieval == "ann")
        before = {u: pair.pmodel.recommend(u, 10) for u in ("u3", "u9", "newbie")}
        assert before["newbie"] == []
        _fold_events(pair)
        assert pair.tick() == 8           # the view is not tailed (event_names)
        _same_overlays(pair.psvc, pair.jsvc)
        assert pair.psvc.overlay.item("fresh") is not None
        assert pair.psvc.overlay.user("newbie") is not None
        for user, num, exclude_seen, allow in _queries(pair):
            got = pair.pmodel.recommend(user, num, allow=allow, exclude_seen=exclude_seen)
            want = pair.jmodel.recommend(user, num, allow=allow, exclude_seen=exclude_seen)
            _same_answers(got, want)
        # the fold changed u3's answer and hides what u3 just rated
        after = pair.pmodel.recommend("u3", 100)
        assert after[:10] != before["u3"]
        assert not {"i5", "i7"} & {i for i, _ in after}
        # fresh is merged for everyone but its own raters
        assert "fresh" not in {i for i, _ in pair.pmodel.recommend("u4", N_ITEMS)}
        assert "fresh" in {i for i, _ in pair.pmodel.recommend("u9", N_ITEMS)}
        assert pair.pmodel.needs_online_path("u9")
        m, j = pair.psvc.metrics(), pair.jsvc.metrics()
        for key in ("foldedEventsTotal", "foldCycles", "usersFoldedTotal", "itemsAddedTotal",
                    "overlayUsers", "overlayItems", "fenced", "errorsTotal"):
            assert m[key] == j[key], key
        assert set(pair.psvc.stats_doc()) == set(pair.jsvc.stats_doc())

    def test_batch_predict_routes_overlay_users_to_the_online_path(self, pair):
        _fold_events(pair)
        pair.tick()
        algo = pair.pdep.algorithms[0]
        queries = [(0, prec.Query(user="u3", num=10)), (1, prec.Query(user="u9", num=5)),
                   (2, prec.Query(user="newbie", num=5))]
        got = dict(algo.batch_predict(pair.pmodel, queries))
        for qi, q in queries:
            want = pair.jmodel.recommend(q.user, q.num)
            _same_answers([(s.item, s.score) for s in got[qi].item_scores], want)

    def test_folded_vector_is_the_full_history_solve(self, pair):
        pair.post(("rate", "u1", "i0", {"rating": 4.0}), ("buy", "u1", "i1", None))
        pair.tick()
        delta = pair.psvc.overlay.user("u1")
        Y = pair.pmodel.item_factors.double().numpy()
        ixs, ratings = [], []
        for e in pair.pstorage.get_events().find(pair.app_id, None):
            if e.entity_id != "u1" or e.target_entity_id is None:
                continue
            ratings.append(float(e.properties.fields["rating"]) if e.event == "rate" else 4.0)
            ixs.append(pair.pmodel.item_ids.get(e.target_entity_id))
        obs = Y[np.asarray(ixs)]
        A = obs.T @ obs + LAM * len(ixs) * np.eye(RANK)
        ref = np.linalg.solve(A, np.asarray(ratings) @ obs)
        np.testing.assert_allclose(delta.vector, ref, rtol=1e-4, atol=1e-4)
        assert delta.extra_seen == tuple(sorted(set(ixs)))

    def test_overlay_items_leave_the_base_ranking_unchanged_under_ann(self, pair):
        pair.pmodel.configure_retrieval("ann")
        baseline = pair.pmodel.recommend("u1", 10)
        ov = overlay.OnlineOverlay(generation=0)
        ov.put_item("cold", overlay.ItemDelta(np.full((RANK,), 1e-6, np.float32)),
                    generation=0)
        pair.pmodel.set_online_overlay(ov)
        with_overlay = [r for r in pair.pmodel.recommend("u1", 11) if r[0] != "cold"]
        _same_answers(with_overlay[:10], baseline)


class TestReload:
    def test_generation_fence_and_refold_equal_jax(self, pair):
        pair.post(("rate", "u4", "i2", {"rating": 5.0}))
        pair.tick()
        stale = pair.psvc.overlay.user("u4")
        assert stale is not None
        # a reload: new models (other factors), the generation moves
        pair.jdep, pair.pdep = _jax_deployed(seed=1), _port_deployed(seed=1)
        pair.gen = 1
        pair.psvc.on_model_swapped(1)
        pair.jsvc.on_model_swapped(1)
        assert pair.psvc.overlay.user("u4") is None
        assert pair.pmodel.online_overlay is pair.psvc.overlay
        assert not pair.psvc.overlay.put_user("u4", stale, generation=0)
        assert not pair.jsvc.overlay.put_user("u4", joverlay.UserDelta(vector=stale.vector),
                                              generation=0)
        assert pair.psvc.overlay.counters()["fenced"] == 1
        # the refold queue re-solves u4 against the new model, no new event
        assert pair.tick() == 0
        _same_overlays(pair.psvc, pair.jsvc)
        refolded = pair.psvc.overlay.user("u4")
        assert refolded is not None and not np.allclose(refolded.vector, stale.vector)
        _same_answers(pair.pmodel.recommend("u4", 10), pair.jmodel.recommend("u4", 10))

    def test_a_fold_racing_a_reload_is_discarded_and_replayed(self, pair):
        pair.post(("rate", "u2", "i3", {"rating": 5.0}))
        real = pair.psvc._follower.poll_once

        def poll_then_reload():
            out = real()
            pair.psvc.overlay.advance_generation(1)   # /reload lands mid-cycle
            return out

        pair.psvc._follower.poll_once = poll_then_reload
        pair.psvc.tick()
        pair.psvc._follower.poll_once = real
        assert pair.psvc.overlay.user("u2") is None
        assert pair.psvc.metrics()["foldedEventsTotal"] == 0
        pair.gen = 1
        assert pair.psvc.tick() == 1            # the cursor did not move
        assert pair.psvc.overlay.user("u2") is not None

    def test_engine_service_reload_moves_the_generation(self, tmp_path):
        storage = memory_storage()
        app_id = storage.get_meta_data_apps().insert(App(0, APP))
        storage.get_events().init(app_id)
        model = _port_deployed().models[0]
        ids = []
        for n in range(2):
            location = str(tmp_path / f"m{n}")
            model.save(location)
            ids.append(storage.get_meta_data_engine_instances().insert(EngineInstance(
                id="", status="COMPLETED", start_time=T0 + timedelta(hours=n),
                completion_time=T0 + timedelta(hours=n), engine_id="e", engine_version="1",
                engine_variant="e", engine_factory=f"{prec.__name__}.engine_factory",
                data_source_params=DS_PARAMS, algorithms_params=ALGO_PARAMS)))
            save_models(storage, ids[-1], [PersistentModelManifest(
                f"{prec.__name__}.ALSAlgorithm", location)])
        server = pserver_mod.create_engine_server(storage, ServerConfig(
            ip="127.0.0.1", port=0, device="cpu", engine_instance_id=ids[0], online=True,
            online_interval_s=3600, cache_enabled=True))
        svc = server.service
        try:
            assert svc.online.enabled and svc.model_generation == 0
            storage.get_events().insert(_event("rate", "u1", "i2", {"rating": 5.0}), app_id)
            assert svc.online.tick() == 1
            assert svc.online.overlay.user("u1") is not None
            assert svc.handle("GET", "/reload", {}, {}, None)[0] == 200
            assert svc.deployed.instance_id == ids[1] and svc.model_generation == 1
            assert svc.online.overlay.generation == 1
            assert svc.online.overlay.user("u1") is None
            assert svc.deployed.models[0].online_overlay is svc.online.overlay
            svc.online.tick()                  # the refold against the new model
            assert svc.online.overlay.user("u1") is not None
            doc = svc.handle("GET", "/stats.json", {}, {}, None)[1]["online"]
            assert doc["generation"] == 1 and doc["enabled"] is True
        finally:
            server.service.close()


# ---------------------------------------------------------------------------
# the result cache
# ---------------------------------------------------------------------------


class TestCache:
    def test_user_key_fragment_equals_jax(self):
        from predictionio_tpu_torch.core.json_codec import canonical_json

        for uid in ("u1", "u11", 'we"ird', "ü"):
            assert service.user_key_fragment(uid) == jservice.user_key_fragment(uid)
        key = canonical_json({"num": 5, "user": "u1"})
        assert service.user_key_fragment("u1") in key
        assert service.user_key_fragment("u11") not in key

    def test_invalidate_matching_is_targeted(self):
        cache = ResultCache()
        cache.put('{"num":5,"user":"u1"}', 1)
        cache.put('{"num":9,"user":"u1"}', 2)
        cache.put('{"num":5,"user":"u2"}', 3)
        gen = cache.generation
        assert cache.invalidate_matching(service.user_key_fragment("u1")) == 2
        assert cache.lookup('{"num":5,"user":"u2"}')[0]
        assert not cache.put('{"num":5,"user":"u1"}', "stale", generation=gen)

    def test_a_fold_invalidates_only_its_users_entries_as_jax(self, store):
        jstorage, pstorage, app_id = store
        services = {
            "port": pserver_mod.EngineService(
                _port_deployed(), ServerConfig(device="cpu", cache_enabled=True, online=True,
                                               online_interval_s=3600), pstorage),
            "jax": jserver_mod.EngineService(
                _jax_deployed(), JaxServerConfig(cache_enabled=True, online=True,
                                                 online_interval_s=3600), jstorage),
        }
        try:
            for svc in services.values():
                assert svc.online.enabled
                for user in ("u5", "u6"):
                    assert svc.handle("POST", "/queries.json", {}, {},
                                      {"user": user, "num": 5})[0] == 200
            pstorage.get_events().insert(_event("rate", "u5", "i3", {"rating": 5.0}), app_id)
            docs = {}
            for name, svc in services.items():
                assert svc.online.tick() == 1
                keys = list(svc.cache._entries)
                assert any(service.user_key_fragment("u6") in k for k in keys), name
                assert not any(service.user_key_fragment("u5") in k for k in keys), name
                answers = {u: svc.handle("POST", "/queries.json", {}, {},
                                         {"user": u, "num": 5})[1] for u in ("u5", "u6")}
                docs[name] = (svc.handle("GET", "/stats.json", {}, {}, None)[1], answers)
            (pdoc, pans), (jdoc, jans) = docs["port"], docs["jax"]
            for key in ("cacheHits", "cacheMisses", "cacheUserInvalidations",
                        "cacheHitRatio"):
                assert pdoc["serving"][key] == jdoc["serving"][key], key
            assert pdoc["serving"]["cacheHitRatio"] == 0.25    # u6 hit; u5 missed twice
            assert set(pdoc["online"]) == set(jdoc["online"])
            for u in ("u5", "u6"):
                _same_answers([(s["item"], s["score"]) for s in pans[u]["itemScores"]],
                              [(s["item"], s["score"]) for s in jans[u]["itemScores"]])
        finally:
            services["port"].close()
            services["jax"].online.close()


class _Hub:
    """What the fold-in service reads of a worker hub."""

    def __init__(self, spool_dir: str, worker_id: str):
        self.spool_dir, self.worker_id = spool_dir, worker_id


def test_a_worker_pool_raises_naming_its_roadmap_item(store, tmp_path):
    """(Named when a worker hub raised, before the pool half was ported.)
    Two workers' fold-in services over one spool and store, in each
    package: the first to tick takes the tail lease and folds, the other
    applies the leader's published snapshot to its own model; leaders,
    sequences, returns, invalidations and overlays equal JAX's, and the
    sibling serves the folded answers."""
    jstorage, pstorage, app_id = store
    runs = {}
    for name, mod, fol, deployed, storage in (
            ("port", service, follower, _port_deployed, pstorage),
            ("jax", jservice, jfollower, _jax_deployed, jstorage)):
        spool = tmp_path / name
        spool.mkdir()
        invalidated: list = []
        deps = [deployed(), deployed()]
        svcs = [mod.OnlineFoldIn(
            storage=storage, deployed_fn=lambda d=d: d, generation_fn=lambda: 0,
            interval_s=3600, initial_cursor=fol.TailCursor(_us(START), ""),
            invalidate_user=lambda u, i=i, out=invalidated: out.append((i, u)),
            worker_hub=_Hub(str(spool), f"w{i}")) for i, d in enumerate(deps)]
        for svc in svcs:
            svc.start()
        runs[name] = dict(deps=deps, svcs=svcs, invalidated=invalidated, trace=[])
    try:
        def step():
            for run in runs.values():
                run["trace"].append([svc.tick() for svc in run["svcs"]] + [
                    (m["leader"], m["appliedSeq"], m["overlayUsers"], m["overlayItems"])
                    for m in (svc.metrics() for svc in run["svcs"])])

        step()
        n = 0
        for ev, user, item, props in (("rate", "u1", "i5", {"rating": 5.0}),
                                      ("rate", "u2", "i7", {"rating": 2.0}),
                                      ("rate", "newbie", "i3", {"rating": 4.0}),
                                      ("rate", "u3", "fresh", {"rating": 5.0})):
            n += 1
            pstorage.get_events().insert_batch(
                [_event(ev, user, item, props, at=START + timedelta(seconds=n))], app_id)
        step()
        step()
        assert runs["port"]["trace"] == runs["jax"]["trace"]
        assert runs["port"]["invalidated"] == runs["jax"]["invalidated"]
        assert sorted(u for i, u in runs["port"]["invalidated"] if i == 1) == \
            ["newbie", "u1", "u2", "u3"]
        leader, sibling = runs["port"]["svcs"]
        _same_overlays(sibling, runs["jax"]["svcs"][1])
        _same_overlays(sibling, leader)
        for user in ("u1", "newbie", "u3"):
            _same_answers(runs["port"]["deps"][1].models[0].recommend(user, 10),
                          runs["port"]["deps"][0].models[0].recommend(user, 10))
    finally:
        for run in runs.values():
            for svc in run["svcs"]:
                svc.close()


def test_online_without_an_als_model_stays_inert(store):
    _, pstorage, _ = store
    dep = _port_deployed()
    dep.models = [object()]
    svc = service.OnlineFoldIn(storage=pstorage, deployed_fn=lambda: dep,
                               generation_fn=lambda: 0)
    svc.start()
    assert not svc.enabled and svc.tick() == 0
    svc.close()
