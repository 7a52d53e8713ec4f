"""The port's classification models and template
(``models/naive_bayes.py``, ``models/logreg.py``,
``models/random_forest.py``, ``templates/classification.py``) against
the JAX package's on the CPU, with seeded NumPy inputs through both.

Tolerances: naive Bayes counts equal and logs within 1e-6 (the same f32
sums and logs); logreg weights after 1 and 10 Adam steps within 1e-7 and
2e-6 (f32 in another summation order; measured at most 3.0e-8 and
5.7e-7 over the cases here), after 300 steps within 2e-5 (measured
5.2e-6) with the argmax labels equal (well-separated data); forest
node tables and votes equal; template scores within 1e-5 and labels
equal; the Accuracy report equal.
"""

from __future__ import annotations

import dataclasses
import json
import urllib.request
from datetime import datetime, timedelta, timezone

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.sharding import Mesh as JaxMesh
from predictionio_tpu.controller import EngineParams as JaxEngineParams
from predictionio_tpu.controller import EngineParamsGenerator as JaxEngineParamsGenerator
from predictionio_tpu.core.datamap import DataMap as JaxDataMap
from predictionio_tpu.core.event import Event as JaxEvent
from predictionio_tpu.models import logreg as jlr
from predictionio_tpu.models import naive_bayes as jnb
from predictionio_tpu.models import random_forest as jrf
from predictionio_tpu.storage.base import App as JaxApp
from predictionio_tpu.templates import classification as jcls
from predictionio_tpu.utils.testing import memory_storage as jax_memory_storage
from predictionio_tpu.workflow.context import EngineContext as JaxEngineContext
from predictionio_tpu.workflow.evaluation import run_evaluation as jax_run_evaluation
from predictionio_tpu_torch.api.engine_server import create_engine_server
from predictionio_tpu_torch.parallel.mesh import Mesh
from predictionio_tpu_torch.controller import EngineParams, EngineParamsGenerator
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.models import logreg as plr
from predictionio_tpu_torch.models import naive_bayes as pnb
from predictionio_tpu_torch.models import random_forest as prf
from predictionio_tpu_torch.storage.base import App
from predictionio_tpu_torch.storage.registry import memory_storage
from predictionio_tpu_torch.templates import classification as pcls
from predictionio_tpu_torch.workflow.context import EngineContext
from predictionio_tpu_torch.workflow.deploy import ServerConfig
from predictionio_tpu_torch.workflow.evaluation import run_evaluation
from tests.test_torch_similarproduct import fill

LOG_TOL = 1e-6
LOGREG_TOL = {1: 1e-7, 10: 2e-6, 300: 2e-5}
SCORE_TOL = 1e-5
T0 = datetime(2026, 3, 1, tzinfo=timezone.utc)
APP = "ClassApp"


def counts_data(seed=0, n=600, f=12, c=4):
    """Non-negative count features whose rates depend on the class."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n).astype(np.int32)
    rates = rng.uniform(0.2, 4.0, (c, f))
    return rng.poisson(rates[y]).astype(np.float32), y


def separated_data(seed=0, n=600, f=10, c=4):
    """Gaussian clusters three standard deviations apart."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n).astype(np.int32)
    centers = rng.standard_normal((c, f)) * 3.0
    return (centers[y] + rng.standard_normal((n, f))).astype(np.float32), y


class TestNaiveBayes:
    @pytest.mark.parametrize("smoothing", [0.5, 1.0, 2.0])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_multinomial_equals_jax(self, smoothing, seed):
        X, y = counts_data(seed)
        ones = np.ones(len(y), np.float32)
        wc, ws = jnb._multinomial_counts(jnp.asarray(X), jnp.asarray(y), jnp.asarray(ones), 4)
        gc, gs = pnb._multinomial_counts(torch.tensor(X), torch.tensor(y), torch.tensor(ones), 4)
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        want = jnb.train_multinomial(X, y, 4, smoothing)
        got = pnb.train_multinomial(X, y, 4, smoothing, device="cpu")
        np.testing.assert_allclose(got.log_prior.numpy(), np.asarray(want.log_prior),
                                   rtol=LOG_TOL, atol=LOG_TOL)
        np.testing.assert_allclose(got.log_theta.numpy(), np.asarray(want.log_theta),
                                   rtol=LOG_TOL, atol=LOG_TOL)
        scores = pnb.predict_multinomial_scores(got.log_prior, got.log_theta, torch.tensor(X))
        np.testing.assert_allclose(scores.numpy(), np.asarray(jnb.predict_multinomial_scores(
            want.log_prior, want.log_theta, jnp.asarray(X))), rtol=LOG_TOL, atol=1e-4)
        np.testing.assert_array_equal(pnb.predict_multinomial(got, X),
                                      jnb.predict_multinomial(want, X))

    def test_a_class_absent_from_the_data_gets_a_finite_prior(self):
        X, y = counts_data(2)
        y = np.where(y == 3, 0, y).astype(np.int32)
        got = pnb.train_multinomial(X, y, 4, device="cpu")
        want = jnb.train_multinomial(X, y, 4)
        assert torch.isfinite(got.log_prior).all()
        np.testing.assert_allclose(got.log_prior.numpy(), np.asarray(want.log_prior),
                                   rtol=LOG_TOL, atol=LOG_TOL)

    @pytest.mark.parametrize("num_values", [3, 6])
    def test_categorical_equals_jax(self, num_values):
        rng = np.random.default_rng(num_values)
        y = rng.integers(0, 3, 400).astype(np.int32)
        X = ((y[:, None] + rng.integers(0, num_values, (400, 5))) % num_values).astype(np.int32)
        X[rng.random(X.shape) < 0.1] = -1                    # missing values
        ones = np.ones(len(y), np.float32)
        wc, wt = jnb._categorical_counts(jnp.asarray(X), jnp.asarray(y), jnp.asarray(ones), 3,
                                         num_values)
        gc, gt = pnb._categorical_counts(torch.tensor(X), torch.tensor(y), torch.tensor(ones),
                                         3, num_values)
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
        want = jnb.train_categorical(X, y, 3, num_values)
        got = pnb.train_categorical(X, y, 3, num_values, device="cpu")
        for name in ("log_prior", "log_likelihood", "default_log"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=LOG_TOL, atol=LOG_TOL, err_msg=name)
        Xq = X.copy()
        Xq[:5, 0] = -1
        ws = jnb.predict_categorical_scores(want.log_prior, want.log_likelihood,
                                            want.default_log, jnp.asarray(Xq))
        gs = pnb.predict_categorical_scores(got.log_prior, got.log_likelihood, got.default_log,
                                            torch.tensor(Xq))
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=LOG_TOL, atol=1e-5)
        np.testing.assert_array_equal(pnb.predict_categorical(got, Xq),
                                      jnb.predict_categorical(want, Xq))

    def test_params_from_jax_round_trip(self):
        X, y = counts_data(3)
        want = jnb.train_multinomial(X, y, 4)
        got = pnb.params_from_jax(np.asarray(want.log_prior), np.asarray(want.log_theta),
                                  device="cpu")
        np.testing.assert_array_equal(got.log_theta.numpy(), np.asarray(want.log_theta))
        np.testing.assert_array_equal(pnb.predict_multinomial(got, X),
                                      jnb.predict_multinomial(want, X))
        Xc = (X > 1).astype(np.int32)
        cw = jnb.train_categorical(Xc, y, 4, 2)
        cg = pnb.categorical_params_from_jax(*(np.asarray(a) for a in (
            cw.log_prior, cw.log_likelihood, cw.default_log)), device="cpu")
        np.testing.assert_array_equal(cg.log_likelihood.numpy(), np.asarray(cw.log_likelihood))
        np.testing.assert_array_equal(pnb.predict_categorical(cg, Xc),
                                      jnb.predict_categorical(cw, Xc))

    def test_mesh_and_the_card_default(self):
        X, y = counts_data()
        # a mesh counts over its "data" axis: exactly the unsharded counts
        mesh = Mesh(np.asarray(["cpu"] * 4, dtype=object).reshape(2, 2), ("data", "model"))
        for a, b in ((pnb.train_multinomial(X, y, 4, mesh=mesh),
                      pnb.train_multinomial(X, y, 4, device="cpu")),
                     (pnb.train_categorical(X.astype(np.int32) % 3, y, 4, 3, mesh=mesh),
                      pnb.train_categorical(X.astype(np.int32) % 3, y, 4, 3, device="cpu"))):
            for field in dataclasses.fields(a):
                assert torch.equal(getattr(a, field.name), getattr(b, field.name))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                pnb.train_multinomial(X, y, 4)
        # a tensor already on a device stays there
        assert pnb.train_multinomial(torch.tensor(X), y, 4).log_prior.device.type == "cpu"


class TestLogReg:
    @pytest.mark.parametrize("steps", [1, 10, 300])
    def test_weights_equal_jax(self, steps):
        X, y = separated_data()
        want = np.asarray(jlr.train_logreg(X, y, 4, iterations=steps).weights)
        got = plr.train_logreg(X, y, 4, iterations=steps, device="cpu")
        np.testing.assert_allclose(got.weights.numpy(), want, rtol=0, atol=LOGREG_TOL[steps])
        if steps == 300:
            labels = plr.predict_logreg(got, X)
            np.testing.assert_array_equal(labels, jlr.predict_logreg(jlr.LogRegModel(
                jnp.asarray(want)), X))
            assert (labels == y).mean() > 0.95

    @pytest.mark.parametrize("l2,lr", [(1e-4, 0.1), (1e-2, 0.05), (0.0, 0.2)])
    def test_hyperparameters_equal_jax(self, l2, lr):
        X, y = separated_data(1, n=300, f=6, c=3)
        want = np.asarray(jlr.train_logreg(X, y, 3, l2=l2, lr=lr, iterations=10).weights)
        got = plr.train_logreg(X, y, 3, l2=l2, lr=lr, iterations=10, device="cpu")
        np.testing.assert_allclose(got.weights.numpy(), want, rtol=0, atol=LOGREG_TOL[10])

    def test_closed_form_gradient_equals_autograd(self):
        """The explicit gradient against autograd of the same loss, the
        bias row without L2."""
        X, y = separated_data(2, n=200, f=5, c=3)
        Xb = plr._add_bias(torch.tensor(X))
        one_hot = torch.nn.functional.one_hot(torch.tensor(y).long(), 3).float()
        mask = torch.ones(len(y))
        mask[-7:] = 0.0                                       # padded rows
        W = torch.randn(Xb.shape[1], 3, generator=torch.Generator().manual_seed(0),
                        requires_grad=True)
        loss, grad = plr._loss_and_grad(Xb, one_hot, mask, mask.sum(), W.detach(), 0.3)
        ce = -(one_hot * torch.log_softmax(Xb @ W, 1)).sum(1) * mask
        ref = ce.sum() / mask.sum() + 0.3 * (W[:-1] ** 2).sum()
        ref.backward()
        torch.testing.assert_close(loss, ref.detach(), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(grad, W.grad, rtol=1e-5, atol=1e-6)

    def test_scores_and_params_from_jax(self):
        X, y = separated_data(3)
        want = jlr.train_logreg(X, y, 4, iterations=20)
        got = plr.params_from_jax(np.asarray(want.weights), device="cpu")
        np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights))
        np.testing.assert_allclose(
            plr.predict_logreg_scores(got.weights, torch.tensor(X)).numpy(),
            np.asarray(jlr.predict_logreg_scores(want.weights, jnp.asarray(X))),
            rtol=SCORE_TOL, atol=SCORE_TOL)
        # a mesh fits over its "data" axis, as JAX's sharded fit does on the
        # same mesh (both differ from the unsharded fit where Adam divides
        # a near-zero gradient by its own size: the order of the sums shows)
        shape = (4, 2)
        jmesh = JaxMesh(np.asarray(jax.devices()[:8]).reshape(shape), ("data", "model"))
        mesh = Mesh(np.asarray(["cpu"] * 8, dtype=object).reshape(shape), ("data", "model"))
        np.testing.assert_allclose(
            plr.train_logreg(X, y, 4, iterations=10, mesh=mesh).weights.numpy(),
            np.asarray(jlr.train_logreg(X, y, 4, iterations=10, mesh=jmesh).weights),
            rtol=0, atol=LOGREG_TOL[10])


FOREST_CASES = [
    dict(num_trees=5, max_depth=4, min_leaf=1, feature_subset="sqrt", seed=1),
    dict(num_trees=3, max_depth=6, min_leaf=3, feature_subset="all", seed=2),
    dict(num_trees=8, max_depth=2, min_leaf=1, feature_subset="sqrt", seed=3),
]


class TestRandomForest:
    @pytest.mark.parametrize("kw", FOREST_CASES, ids=lambda kw: json.dumps(kw))
    def test_tables_and_votes_equal_jax(self, kw):
        X, y = separated_data(4, n=400, f=9, c=4)
        X = np.round(X, 1)                                   # ties between values
        want = jrf.train_forest(X, y, 4, **kw)
        got = prf.train_forest(X, y, 4, **kw)
        for name in ("feature", "threshold", "left", "right", "leaf_class"):
            assert getattr(got, name).dtype == getattr(want, name).dtype
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
        Xq = np.concatenate([X, np.random.default_rng(5).standard_normal((50, 9)) * 4])
        votes = prf.predict_forest(got, Xq, device="cpu")
        np.testing.assert_array_equal(votes, jrf.predict_forest(want, Xq))
        assert (votes.sum(1) == kw["num_trees"]).all()
        np.testing.assert_array_equal(prf.predict_forest(got, Xq[0], device="cpu"),
                                      jrf.predict_forest(want, Xq[0]))

    def test_params_from_jax_round_trip(self):
        X, y = separated_data(6, n=200, f=4, c=3)
        want = jrf.train_forest(X, y, 3, num_trees=4, max_depth=3, seed=7)
        got = prf.params_from_jax(want.feature, want.threshold, want.left, want.right,
                                  want.leaf_class, want.max_depth, want.num_classes)
        assert got.num_trees == 4
        np.testing.assert_array_equal(prf.predict_forest(got, X, device="cpu"),
                                      jrf.predict_forest(want, X))
        with pytest.raises(ValueError):
            prf.train_forest(X, y, 3, feature_subset="log2")


# ---------------------------------------------------------------------------
# The template
# ---------------------------------------------------------------------------

ATTRS = ("attr0", "attr1", "attr2")


def entity_events(seed=0, n=90):
    """``$set`` events of n users: three plans, attrs drawn around each
    plan's rates; plus a user without a label, one whose label is
    ``$unset`` and one set in two events."""
    rng = np.random.default_rng(seed)
    plans = ("basic", "premium", "standard")
    rates = np.asarray([[4.0, 0.5, 1.0], [0.5, 4.0, 1.0], [1.0, 1.0, 4.0]])
    out = []

    def add(event, eid, props):
        out.append(dict(event=event, entity_type="user", entity_id=eid,
                        target_entity_type=None, target_entity_id=None, properties=props,
                        event_time=T0 + timedelta(seconds=len(out)), event_id=f"e{len(out):04d}"))

    for u in range(n):
        k = int(rng.integers(0, 3))
        attrs = rng.poisson(rates[k]).astype(float)
        add("$set", f"u{u:03d}", {**{a: float(v) for a, v in zip(ATTRS, attrs)},
                                  "plan": plans[k]})
    add("$set", "nolabel", {a: 1.0 for a in ATTRS})
    add("$set", "unset", {**{a: 1.0 for a in ATTRS}, "plan": "basic"})
    add("$unset", "unset", {"plan": None})
    add("$set", "split", {"attr0": 5.0, "plan": "basic"})
    add("$set", "split", {"attr1": 0.0, "attr2": 1.0})
    return out


@pytest.fixture
def stores():
    events = entity_events()
    return (fill(memory_storage(), App, Event, DataMap, events, app=APP),
            fill(jax_memory_storage(), JaxApp, JaxEvent, JaxDataMap, events, app=APP))


def ctx(storage):
    return EngineContext(storage=storage, device="cpu")


def _components(module, algorithms, serving=""):
    engine = module.engine_factory()
    ep = engine.params_from_variant_json({
        "datasource": {"params": {"appName": APP}}, "algorithms": algorithms,
        "serving": {"name": serving}})
    ds, prep, algos, srv = engine.make_components(ep)
    for a in algos:
        a.params = dataclasses.replace(a.params, use_mesh=False)
    return ds, prep, algos, srv


BOTH = [{"name": "naive", "params": {"smoothing": 1.0}},
        {"name": "logreg", "params": {"iterations": 60, "lr": 0.1}}]
QUERIES = [(4.0, 0.0, 1.0), (0.0, 5.0, 1.0), (1.0, 1.0, 6.0), (2.0, 2.0, 2.0), (0.0, 0.0, 0.0)]


class TestTemplate:
    def test_training_data_equals_jax(self, stores):
        got = pcls.ClassificationDataSource(pcls.DataSourceParams(app_name=APP)).read_training(
            ctx(stores[0]))
        want = jcls.ClassificationDataSource(jcls.DataSourceParams(app_name=APP)).read_training(
            JaxEngineContext(storage=stores[1]))
        np.testing.assert_array_equal(got.features, want.features)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert got.features.dtype == np.float32 and got.labels.dtype == np.int32
        assert got.label_map.to_dict() == want.label_map.to_dict()
        assert len(got.labels) == 91                        # 90 + "split"; two dropped

    @pytest.mark.parametrize("serving", ["", "blended"])
    @pytest.mark.parametrize("algorithms", [BOTH[:1], BOTH[1:], BOTH],
                             ids=["naive", "logreg", "both"])
    def test_predictions_equal_jax(self, stores, algorithms, serving):
        results = []
        for module, storage, make_ctx in ((pcls, stores[0], ctx),
                                          (jcls, stores[1], lambda s: JaxEngineContext(storage=s))):
            ds, prep, algos, srv = _components(module, algorithms, serving)
            c = make_ctx(storage)
            pd = prep.prepare(c, ds.read_training(c))
            models = [a.train(c, pd) for a in algos]
            queries = [(k, module.Query(attrs=q)) for k, q in enumerate(QUERIES)]
            per_algo = [dict(a.batch_predict(m, queries)) for a, m in zip(algos, models)]
            for p, a, m in zip(per_algo, algos, models):     # batch against single
                single = a.predict(m, queries[1][1])
                assert p[1].label == single.label
                np.testing.assert_allclose(list(p[1].scores.values()),
                                           list(single.scores.values()), rtol=SCORE_TOL)
            results.append([srv.serve(q, [p[k] for p in per_algo]) for k, q in queries])
        for got, want in zip(*results):
            assert got.label == want.label
            assert got.scores.keys() == want.scores.keys()
            np.testing.assert_allclose([got.scores[k] for k in want.scores],
                                       list(want.scores.values()), rtol=SCORE_TOL, atol=1e-4)

    def test_folds_equal_jax(self, stores):
        got = pcls.ClassificationDataSource(pcls.DataSourceParams(app_name=APP, eval_k=3)
                                            ).read_eval(ctx(stores[0]))
        want = jcls.ClassificationDataSource(jcls.DataSourceParams(app_name=APP, eval_k=3)
                                             ).read_eval(JaxEngineContext(storage=stores[1]))
        assert len(got) == len(want) == 3
        for (gtd, gei, gqa), (wtd, wei, wqa) in zip(got, want):
            assert gei == wei
            np.testing.assert_array_equal(gtd.features, wtd.features)
            np.testing.assert_array_equal(gtd.labels, wtd.labels)
            assert [(tuple(q.attrs), a) for q, a in gqa] == [(tuple(q.attrs), a) for q, a in wqa]

    def test_accuracy_grid_report_equals_jax(self, stores, tmp_path):
        got = run_evaluation(
            pcls.ClassificationEvaluation(output_path=str(tmp_path / "port.json")),
            pcls.DefaultParamsList(app_name=APP), storage=stores[0], ctx=ctx(stores[0])).result
        want = jax_run_evaluation(
            jcls.ClassificationEvaluation(output_path=str(tmp_path / "jax.json")),
            jcls.DefaultParamsList(app_name=APP), storage=stores[1]).result
        assert [s.score for _, s in got.engine_params_scores] == \
            [s.score for _, s in want.engine_params_scores]
        assert got.best_idx == want.best_idx and 0.5 < got.best_score.score <= 1.0
        assert got.to_one_liner() == want.to_one_liner()
        assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()

    def test_mixed_grid_with_logreg_equals_jax(self, stores, tmp_path):
        """A grid of naive Bayes and logreg points (both learners in one
        engine, blended) through both packages' run_evaluation."""
        def grid(mod, ep, gen):
            return gen([dataclasses.replace(
                ep.of(data_source=mod.DataSourceParams(app_name=APP, eval_k=3),
                      algorithms=algos), serving_params=("blended", ep.of().serving_params[1]))
                        for algos in ([("naive", mod.AlgorithmParams(smoothing=1.0))],
                                      [("naive", mod.AlgorithmParams(smoothing=1.0)),
                                       ("logreg", mod.LogRegAlgorithmParams(iterations=40))])])
        got = run_evaluation(pcls.ClassificationEvaluation(output_path=None),
                             grid(pcls, EngineParams, EngineParamsGenerator),
                             storage=stores[0], ctx=ctx(stores[0])).result
        want = jax_run_evaluation(jcls.ClassificationEvaluation(output_path=None),
                                  grid(jcls, JaxEngineParams, JaxEngineParamsGenerator),
                                  storage=stores[1]).result
        assert [s.score for _, s in got.engine_params_scores] == \
            [s.score for _, s in want.engine_params_scores]

    def test_train_deploy_blended_over_http(self, stores, tmp_path, monkeypatch):
        from predictionio_tpu_torch.workflow.train import run_train

        monkeypatch.setenv("PIO_MODEL_DIR", str(tmp_path))
        variant = {"engineFactory":
                   "predictionio_tpu_torch.templates.classification.engine_factory",
                   "datasource": {"params": {"appName": APP}},
                   "algorithms": BOTH, "serving": {"name": "blended"}}
        outcome = run_train(variant=variant, ctx=ctx(stores[0]))
        assert outcome.status == "COMPLETED"
        ds, prep, algos, srv = _components(jcls, BOTH, "blended")
        jc = JaxEngineContext(storage=stores[1])
        pd = prep.prepare(jc, ds.read_training(jc))
        models = [a.train(jc, pd) for a in algos]
        server = create_engine_server(stores[0], ServerConfig(
            ip="127.0.0.1", port=0, device="cpu")).start()
        try:
            for q in QUERIES:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{server.port}/queries.json",
                    data=json.dumps({"attrs": list(q)}).encode(), method="POST",
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=30) as resp:
                    doc = json.loads(resp.read())
                want = srv.serve(jcls.Query(attrs=q), [a.predict(m, jcls.Query(attrs=q))
                                                       for a, m in zip(algos, models)])
                assert doc["label"] == want.label
                np.testing.assert_allclose([doc["scores"][k] for k in want.scores],
                                           list(want.scores.values()), rtol=SCORE_TOL,
                                           atol=1e-4)
        finally:
            server.stop()

    def test_empty_data_is_refused(self):
        empty = memory_storage()
        empty.get_meta_data_apps().insert(App(0, APP))
        ds, *_ = _components(pcls, BOTH[:1])
        td = ds.read_training(ctx(empty))
        with pytest.raises(ValueError, match="training data is empty"):
            td.sanity_check()
