"""The port's recommendation evaluation on the CPU, against the JAX
package's template: the same k-fold splits of the same events, the same
Precision@K and MAP@K of the same triples, the same scores from
``run_evaluation`` when the port's ALS starts from JAX's initial item
factors, and the through-framework MAP@10 of
tests/test_quality_parity.py on the vendored MovieLens sample against
the JAX package's harness metric.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from predictionio_tpu.controller import EngineParams as JaxEngineParams
from predictionio_tpu.controller import EngineParamsGenerator as JaxEngineParamsGenerator
from predictionio_tpu.core.datamap import DataMap as JaxDataMap
from predictionio_tpu.core.event import Event as JaxEvent
from predictionio_tpu.data.movielens import RatingsDataset, load_ratings_file
from predictionio_tpu.e2 import quality
from predictionio_tpu.storage.base import App as JaxApp
from predictionio_tpu.templates import recommendation as jrec
from predictionio_tpu.utils.testing import memory_storage as jax_memory_storage
from predictionio_tpu.workflow.context import EngineContext as JaxEngineContext
from predictionio_tpu.workflow.evaluation import run_evaluation as jax_run_evaluation
from predictionio_tpu_torch.controller import EngineParams, EngineParamsGenerator
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.storage.base import App
from predictionio_tpu_torch.storage.registry import memory_storage
from predictionio_tpu_torch.templates import recommendation as prec
from predictionio_tpu_torch.workflow.context import EngineContext
from predictionio_tpu_torch.workflow.evaluation import run_evaluation
from tests.test_torch_recommendation import _events, _fill

DATA = os.path.join(os.path.dirname(__file__), "..", "examples", "data",
                    "sample_movielens.txt")


@pytest.fixture
def stores():
    """(port storage, JAX storage) with test_torch_recommendation.py's
    events: two taste clusters plus the rows the data source drops."""
    events = _events()
    return (_fill(memory_storage(), App, Event, DataMap, events),
            _fill(jax_memory_storage(), JaxApp, JaxEvent, JaxDataMap, events))


def _ctx(storage):
    return EngineContext(storage=storage, device="cpu")


def _folds(folds):
    return [((td.users.tolist(), td.items.tolist(), td.ratings.tolist()), ei,
             [(dataclasses.asdict(q), a) for q, a in qa]) for td, ei, qa in folds]


class TestReadEval:
    @pytest.mark.parametrize("eval_k, seed, num", [(2, 3, 10), (3, 3, 5), (5, 11, 10),
                                                   (1, 0, 20)])
    def test_folds_equal_jax(self, stores, eval_k, seed, num):
        port, jax_storage = stores
        params = dict(app_name="RecApp", eval_k=eval_k, seed=seed, eval_query_num=num)
        got = prec.RecommendationDataSource(prec.DataSourceParams(**params)).read_eval(
            _ctx(port))
        want = jrec.RecommendationDataSource(jrec.DataSourceParams(**params)).read_eval(
            JaxEngineContext(storage=jax_storage))
        assert _folds(got) == _folds(want)
        assert len(got) == eval_k
        full = prec.RecommendationDataSource(prec.DataSourceParams(app_name="RecApp")
                                             ).read_training(_ctx(port))
        # every rating lands in exactly one fold's test set
        assert sum(len(a) for _, _, qa in got for _, a in qa) == len(full.users)
        assert all(len(td.users) + sum(len(a) for _, a in qa) == len(full.users)
                   for td, _, qa in got)

    def test_zero_folds_raise_as_jax(self, stores):
        port, jax_storage = stores
        with pytest.raises(ValueError):
            prec.RecommendationDataSource(prec.DataSourceParams(app_name="RecApp")).read_eval(
                _ctx(port))
        with pytest.raises(ValueError):
            jrec.RecommendationDataSource(jrec.DataSourceParams(app_name="RecApp")).read_eval(
                JaxEngineContext(storage=jax_storage))


def _triples(seed: int, port: bool):
    """Seeded (q, p, a) triples: answers of 0-14 items, held-out sets of
    0-6 items (repeats included), in the package's own classes."""
    mod = prec if port else jrec
    rng = np.random.default_rng(seed)
    out = []
    for j in range(60):
        top = [f"i{int(x)}" for x in rng.permutation(20)[: int(rng.integers(0, 15))]]
        p = mod.PredictedResult(tuple(mod.ItemScore(i, 1.0 - n / 20) for n, i in enumerate(top)))
        a = tuple(f"i{int(x)}" for x in rng.integers(0, 20, int(rng.integers(0, 7))))
        out.append((mod.Query(user=f"u{j}"), p, a))
    return out


class TestMetrics:
    @pytest.mark.parametrize("metric", ["PrecisionAtK", "MAPAtK"])
    @pytest.mark.parametrize("k", [1, 5, 10])
    def test_metric_equals_jax(self, metric, k):
        port_metric, jax_metric = getattr(prec, metric)(k), getattr(jrec, metric)(k)
        assert port_metric.header == jax_metric.header
        got, want = _triples(k, port=True), _triples(k, port=False)
        assert [port_metric.calculate_qpa(*t) for t in got] == \
            [jax_metric.calculate_qpa(*t) for t in want]
        assert port_metric.calculate([(0, got[:30]), (1, got[30:])]) == \
            jax_metric.calculate([(0, want[:30]), (1, want[30:])])

    def test_precision_denominator_and_skips(self):
        q = prec.Query(user="u")
        p = prec.PredictedResult(tuple(prec.ItemScore(f"i{n}", 1.0) for n in range(10)))
        metric = prec.PrecisionAtK(10)
        assert metric.calculate_qpa(q, p, ("i0", "i3")) == 1.0        # 2 / min(10, 2)
        assert metric.calculate_qpa(q, p, ()) is None
        assert metric.calculate_qpa(q, prec.PredictedResult(), ("i0",)) == 0.0
        assert prec.MAPAtK(10).calculate_qpa(q, p, ("i1",)) == 0.5      # hit at rank 2

    def test_evaluation_and_default_grid_equal_jax(self):
        got = prec.DefaultParamsList(app_name="A", eval_k=3).engine_params_list
        want = jrec.DefaultParamsList(app_name="A", eval_k=3).engine_params_list
        assert [(dataclasses.asdict(g.data_source_params[1]),
                 [(n, dataclasses.asdict(p)) for n, p in g.algorithm_params_list])
                for g in got] == \
            [(dataclasses.asdict(w.data_source_params[1]),
              [(n, dataclasses.asdict(p)) for n, p in w.algorithm_params_list]) for w in want]
        evaluator = prec.RecommendationEvaluation(k=7).evaluator
        assert evaluator.metric.header == "Precision@7"
        assert [m.header for m in evaluator.other_metrics] == ["MAP@7"]
        assert evaluator.output_path == "best.json"


GRID = [dict(rank=4, num_iterations=6, lambda_=0.05, seed=3),
        dict(rank=8, num_iterations=8, lambda_=0.1, seed=1)]
#: Precision@10 and MAP@10 of the same grid point through both packages,
#: the port's ALS started from JAX's initial item factors and both in the
#: f32 build (tests/test_torch_recommendation.py holds factor scores to
#: 1e-3, measured ~1e-5): equal but for an item swapped at a near-tie,
#: which would move one user's precision by 1/min(10, |held-out|), the
#: mean over the ~48 queries of the two folds by 2e-3 or more: none may
#: flip here, so only float64 rounding of the means is allowed
METRIC_TOL = 1e-6


class TestRunEvaluationVsJax:
    def test_scores_equal_jax_with_its_item0(self, stores, tmp_path, monkeypatch):
        port, jax_storage = stores
        monkeypatch.setattr(jrec, "als_train",
                            functools.partial(jrec.als_train, matmul_dtype="float32"))
        real = prec.als_train

        def with_jax_item0(coo, *, rank, seed, **kw):
            item0 = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (coo.num_cols, rank),
                                                 dtype=jnp.float32) / jnp.sqrt(jnp.float32(rank)))
            return real(coo, rank=rank, seed=seed, item0=item0, matmul_dtype="float32", **kw)

        monkeypatch.setattr(prec, "als_train", with_jax_item0)
        want = jax_run_evaluation(
            jrec.RecommendationEvaluation(k=10, output_path=str(tmp_path / "jax.json")),
            JaxEngineParamsGenerator([JaxEngineParams.of(
                data_source=jrec.DataSourceParams(app_name="RecApp", eval_k=2),
                algorithms=[("als", jrec.ALSAlgorithmParams(**g, use_mesh=False))])
                for g in GRID]),
            storage=jax_storage).result
        got = run_evaluation(
            prec.RecommendationEvaluation(k=10, output_path=str(tmp_path / "port.json")),
            EngineParamsGenerator([EngineParams.of(
                data_source=prec.DataSourceParams(app_name="RecApp", eval_k=2),
                algorithms=[("als", prec.ALSAlgorithmParams(**g, use_mesh=False))])
                for g in GRID]),
            storage=port, ctx=_ctx(port)).result
        for (_, g), (_, w) in zip(got.engine_params_scores, want.engine_params_scores):
            assert g.score == pytest.approx(w.score, abs=METRIC_TOL)
            assert g.other_scores == pytest.approx(w.other_scores, abs=METRIC_TOL)
            assert 0.0 < g.score <= 1.0
        assert got.best_idx == want.best_idx
        assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()

    def test_preparators_index_folds_alike(self, stores):
        """The dense item order each fold trains on (first seen) is JAX's,
        so JAX's draw indexes the same items on both sides."""
        port, jax_storage = stores
        params = dict(app_name="RecApp", eval_k=2)
        got = prec.RecommendationDataSource(prec.DataSourceParams(**params)).read_eval(
            _ctx(port))
        want = jrec.RecommendationDataSource(jrec.DataSourceParams(**params)).read_eval(
            JaxEngineContext(storage=jax_storage))
        for (td, _, _), (jtd, _, _) in zip(got, want):
            pd = prec.ALSPreparator().prepare(None, td)
            jpd = jrec.ALSPreparator().prepare(JaxEngineContext(storage=jax_storage), jtd)
            assert pd.item_ids.id_to_ix.to_dict() == jpd.item_ids.id_to_ix.to_dict()
            assert pd.user_ids.id_to_ix.to_dict() == jpd.user_ids.id_to_ix.to_dict()


class TestRealSampleThroughFramework:
    def test_end_to_end_map_agreement(self):
        """tests/test_quality_parity.py's through-framework test on the
        port: the vendored MovieLens sample → the port's event store →
        read_eval → ALSPreparator → ALSAlgorithm on the CPU →
        batch_predict → MAPAtK, against the JAX package's harness
        ``ranking_eval`` on the same fold and the port's factors, within
        that test's 0.02."""
        ds = load_ratings_file(DATA)
        storage = memory_storage()
        app_id = storage.get_meta_data_apps().insert(App(0, "QualityApp"))
        storage.get_events().init(app_id)
        storage.get_events().insert_batch([
            Event(event="rate", entity_type="user", entity_id=str(u), target_entity_type="item",
                  target_entity_id=str(i), properties=DataMap({"rating": float(r)}))
            for u, i, r in zip(ds.user_ids(), ds.item_ids(), ds.ratings)], app_id)

        ctx = _ctx(storage)
        td, _, qa = prec.RecommendationDataSource(
            prec.DataSourceParams(app_name="QualityApp", eval_k=3)).read_eval(ctx)[0]
        pd = prec.ALSPreparator().prepare(ctx, td)
        algo = prec.ALSAlgorithm(prec.ALSAlgorithmParams(rank=8, num_iterations=10,
                                                         lambda_=0.05, use_mesh=False))
        model = algo.train(ctx, pd)
        preds = [p for _, p in sorted(algo.batch_predict(model, list(enumerate(
            q for q, _ in qa))), key=lambda t: t[0])]
        metric = prec.MAPAtK(k=10)
        vals = [v for (q, a), p in zip(qa, preds)
                if (v := metric.calculate_qpa(q, p, a)) is not None]
        framework_map = float(np.mean(vals))

        train_ds = RatingsDataset(users=pd.coo.rows, items=pd.coo.cols, ratings=pd.coo.vals,
                                  num_users=pd.coo.num_rows, num_items=pd.coo.num_cols)
        test_by_user = {}
        for q, actual in qa:
            if q.user in pd.user_ids:
                test_by_user[int(pd.user_ids[q.user])] = [
                    (int(pd.item_ids[i]), 5.0) for i in actual if i in pd.item_ids]
        harness = quality.ranking_eval(
            quality.factor_score_fn(model.user_factors.numpy(), model.item_factors.numpy()),
            train_ds, {u: v for u, v in test_by_user.items() if v}, threshold=0.0)
        assert framework_map > 0.0
        assert framework_map == pytest.approx(harness["map@10"], abs=0.02)
