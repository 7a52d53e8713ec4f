"""The port's evaluation layer (``predictionio_tpu_torch/controller/
{metrics,evaluation,fast_eval}.py``, ``Engine.eval``,
``workflow/evaluation.py``, the evaluation-instance DAO) against the JAX
package's on the CPU: the same metrics of the same seeded data sets, the
same reports and ``best.json`` for the same grid, the same instance
lifecycle, and FastEvalEngine's prefix sharing, with a port copy of the
JAX tests' sample engine (tests/sample_engine.py).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Sequence

import numpy as np
import pytest

from predictionio_tpu.controller import metrics as jmetrics
from predictionio_tpu.controller.evaluation import MetricEvaluator as JaxMetricEvaluator
from predictionio_tpu.workflow.context import EngineContext as JaxEngineContext
from predictionio_tpu_torch.controller import (
    Algorithm,
    AverageMetric,
    DataSource,
    Engine,
    EngineParams,
    EngineParamsGenerator,
    Evaluation,
    FastEvalEngine,
    MetricEvaluator,
    OptionAverageMetric,
    OptionStdevMetric,
    Params,
    Preparator,
    SanityCheck,
    Serving,
    StdevMetric,
    SumMetric,
    ZeroMetric,
)
from predictionio_tpu_torch.controller import metrics as pmetrics
from predictionio_tpu_torch.controller.evaluation import BaseEvaluator, BaseEvaluatorResult
from predictionio_tpu_torch.controller.evaluation import best_json_variant
from predictionio_tpu_torch.storage.registry import memory_storage
from predictionio_tpu_torch.workflow.context import EngineContext, WorkflowParams
from predictionio_tpu_torch.workflow.evaluation import (
    PARALLEL_ITEM,
    resolve_parallel,
    run_evaluation,
)
from tests import sample_engine as jax_sample

# ---------------------------------------------------------------------------
# The port's sample engine: tests/sample_engine.py over the port's classes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DSParams(Params):
    id: int = 0
    n_train: int = 4
    n_folds: int = 0
    fail: bool = False


@dataclasses.dataclass(frozen=True)
class AlgoParams(Params):
    id: int = 0
    mult: int = 1


@dataclasses.dataclass(frozen=True)
class TrainingData(SanityCheck):
    id: int
    items: tuple = ()
    bad: bool = False

    def sanity_check(self) -> None:
        if self.bad:
            raise ValueError(f"training data {self.id} failed sanity check")


@dataclasses.dataclass(frozen=True)
class PreparedData:
    source_id: int
    prep_id: int
    items: tuple = ()


@dataclasses.dataclass(frozen=True)
class Query:
    x: int


@dataclasses.dataclass(frozen=True)
class Prediction:
    value: int
    tags: tuple = ()


@dataclasses.dataclass(frozen=True)
class Model:
    algo_id: int
    mult: int
    source_id: int


class SampleDataSource(DataSource):
    params_class = DSParams

    def read_training(self, ctx) -> TrainingData:
        return TrainingData(id=self.params.id, items=tuple(range(self.params.n_train)))

    def read_eval(self, ctx):
        p = self.params
        if p.fail:
            raise RuntimeError("datasource configured to fail")
        return [(TrainingData(id=p.id + k, items=tuple(range(p.n_train))), {"fold": k},
                 [(Query(x=i), i * 10) for i in range(3)])
                for k in range(p.n_folds)]


class SamplePreparator(Preparator):
    def prepare(self, ctx, td: TrainingData) -> PreparedData:
        return PreparedData(source_id=td.id, prep_id=1, items=td.items)


class SampleAlgorithm(Algorithm):
    params_class = AlgoParams
    query_class = Query

    def train(self, ctx, pd: PreparedData) -> Model:
        return Model(algo_id=self.params.id, mult=self.params.mult, source_id=pd.source_id)

    def predict(self, model: Model, query: Query) -> Prediction:
        return Prediction(value=query.x * model.mult, tags=(f"algo{model.algo_id}",))


class ReversedAlgorithm(SampleAlgorithm):
    """Answers a batch in reverse order: Engine.eval aligns by index."""

    def batch_predict(self, model, queries):
        return list(reversed(super().batch_predict(model, queries)))


class SampleServing(Serving):
    def serve(self, query: Query, predictions: Sequence[Prediction]) -> Prediction:
        return Prediction(value=sum(p.value for p in predictions),
                          tags=tuple(t for p in predictions for t in p.tags) + ("served",))


def make_engine(engine_cls=Engine, ds=SampleDataSource, prep=SamplePreparator,
                algo=SampleAlgorithm) -> Engine:
    return engine_cls(data_source_class_map=ds, preparator_class_map=prep,
                      algorithm_class_map={"sample": algo, "reversed": ReversedAlgorithm},
                      serving_class_map=SampleServing)


def _grid(mults, n_folds=2, module=None):
    """The JAX tests' grid; ``module`` picks the JAX sample engine's params."""
    ds, ap, of = ((jax_sample.DSParams, jax_sample.AlgoParams, jax_sample.EngineParams.of)
                  if module == "jax" else (DSParams, AlgoParams, EngineParams.of))
    return [of(data_source=ds(id=1, n_train=4, n_folds=n_folds),
               algorithms=[("sample", ap(id=0, mult=m))]) for m in mults]


class PredictionValueMetric(AverageMetric):
    def calculate_qpa(self, q, p, a):
        return float(p.value)


class SumValueMetric(SumMetric):
    def calculate_qpa(self, q, p, a):
        return float(a)


class JaxPredictionValueMetric(jmetrics.AverageMetric):
    def calculate_qpa(self, q, p, a):
        return float(p.value)

    @property
    def header(self):
        return "PredictionValueMetric"


class JaxSumValueMetric(jmetrics.SumMetric):
    def calculate_qpa(self, q, p, a):
        return float(a)

    @property
    def header(self):
        return "SumValueMetric"


class SampleEvaluation(Evaluation):
    def __init__(self, engine=None, output_path=None):
        super().__init__()
        self.engine_evaluator = (
            engine or make_engine(),
            MetricEvaluator(PredictionValueMetric(), [SumValueMetric()],
                            output_path=output_path))


class SampleGrid(EngineParamsGenerator):
    def __init__(self):
        super().__init__(_grid([1, 2]))


def _ctx(**wp):
    return EngineContext(WorkflowParams(**wp), storage=memory_storage(), device="cpu")


# ---------------------------------------------------------------------------
# Metrics on the same seeded data sets
# ---------------------------------------------------------------------------

_PORT_BASES = {"average": AverageMetric, "option_average": OptionAverageMetric,
               "stdev": StdevMetric, "option_stdev": OptionStdevMetric, "sum": SumMetric,
               "zero": ZeroMetric}
_JAX_BASES = {"average": jmetrics.AverageMetric, "option_average": jmetrics.OptionAverageMetric,
              "stdev": jmetrics.StdevMetric, "option_stdev": jmetrics.OptionStdevMetric,
              "sum": jmetrics.SumMetric, "zero": jmetrics.ZeroMetric}


def _value_metric(base):
    """``base`` scoring each triple by its actual value (None stays None)."""
    return type("ValueMetric", (base,),
                {"calculate_qpa": lambda self, q, p, a: None if a is None else float(a)})()


def _data_set(case: str):
    """Seeded folds of (q, p, actual) triples."""
    rng = np.random.default_rng(11)
    folds = [list(rng.normal(size=int(rng.integers(3, 9)))) for _ in range(3)]
    if case == "with_none":
        folds = [[None if j % 3 == 0 else v for j, v in enumerate(f)] for f in folds]
    elif case == "nan":
        folds[1][0] = math.nan
    elif case == "all_none":
        folds = [[None] * len(f) for f in folds]
    elif case == "empty":
        folds = [[], []]
    return [({"fold": k}, [(f"q{j}", f"p{j}", v) for j, v in enumerate(f)])
            for k, f in enumerate(folds)]


def _outcome(metric, data):
    try:
        return metric.calculate(data)
    except Exception as e:  # the same failure on both sides counts as agreement
        return type(e).__name__


class TestMetrics:
    @pytest.mark.parametrize("case", ["values", "with_none", "nan", "all_none", "empty"])
    @pytest.mark.parametrize("kind", sorted(_PORT_BASES))
    def test_metric_equals_jax(self, kind, case):
        data = _data_set(case)
        got = _outcome(_value_metric(_PORT_BASES[kind]), data)
        want = _outcome(_value_metric(_JAX_BASES[kind]), data)
        if isinstance(want, float):
            assert isinstance(got, float)
            assert (math.isnan(got) and math.isnan(want)) or got == want
        else:
            assert got == want
        if kind == "stdev" and case == "values":
            vals = [v for _, qpa in data for _, _, v in qpa]
            assert got == pytest.approx(float(np.std(vals)))     # population

    @pytest.mark.parametrize("r0, r1", [(2.0, 1.0), (1.0, 2.0), (1.0, 1.0), (math.nan, 0.1),
                                        (0.1, math.nan), (math.nan, math.nan), (-1e9, math.nan),
                                        (3, 2)])
    def test_compare_equals_jax_and_nan_loses(self, r0, r1):
        got = PredictionValueMetric().compare(r0, r1)
        assert got == JaxPredictionValueMetric().compare(r0, r1)
        if isinstance(r0, float) and math.isnan(r0) and not math.isnan(r1):
            assert got < 0

    def test_header_and_eval_data_set_alias(self):
        assert PredictionValueMetric().header == "PredictionValueMetric"
        assert pmetrics.EvalDataSet is not None
        with pytest.raises(NotImplementedError):
            pmetrics.QPAMetric.calculate(PredictionValueMetric(), [])


# ---------------------------------------------------------------------------
# Engine.eval and the MetricEvaluator against the JAX package's
# ---------------------------------------------------------------------------


class TestEngineEval:
    def test_two_algorithms_aligned_by_query_index(self):
        """Two algorithms (one answering its batch reversed) served per
        query as the JAX Engine.eval serves its sample engine."""
        ep = EngineParams.of(data_source=DSParams(id=7, n_train=5, n_folds=2),
                             algorithms=[("sample", AlgoParams(id=0, mult=1)),
                                         ("reversed", AlgoParams(id=1, mult=2))])
        got = make_engine().eval(_ctx(), ep)
        jep = jax_sample.default_params(2)
        want = jax_sample.make_engine().eval(JaxEngineContext(), jep)
        assert [ei for ei, _ in got] == [ei for ei, _ in want] == [{"fold": 0}, {"fold": 1}]
        for (_, g), (_, w) in zip(got, want):
            assert [(q.x, p.value, p.tags, a) for q, p, a in g] == \
                [(q.x, p.value, p.tags, a) for q, p, a in w]
        # query x with mults 1 and 2: x + 2x
        assert [p.value for _, p, _ in got[0][1]] == [0, 3, 6]

    def test_sanity_check_and_empty_read_eval(self):
        class BadDS(SampleDataSource):
            def read_eval(self, ctx):
                return [(TrainingData(id=0, bad=True), {}, [])]

        ep = _grid([1])[0]
        with pytest.raises(ValueError, match="sanity"):
            make_engine(ds=BadDS).eval(_ctx(), ep)
        assert make_engine(ds=BadDS).eval(_ctx(skip_sanity_check=True), ep) == [({}, [])]

        class NoEval(SampleDataSource):
            read_eval = DataSource.read_eval

        assert make_engine(ds=NoEval).eval(_ctx(), ep) == []
        assert make_engine(ds=NoEval).batch_eval(_ctx(), [ep, ep]) == [(ep, []), (ep, [])]


class TestMetricEvaluator:
    def test_best_tracking_and_reports_equal_jax(self, tmp_path):
        port_path, jax_path = tmp_path / "port" / "best.json", tmp_path / "jax" / "best.json"
        evaluation = SampleEvaluation(output_path=str(port_path))
        data = evaluation.engine.batch_eval(_ctx(), _grid([1, 3, 2]))
        got = evaluation.evaluator.evaluate(None, evaluation, data)

        jax_data = jax_sample.make_engine().batch_eval(JaxEngineContext(),
                                                        _grid([1, 3, 2], module="jax"))
        jax_eval = JaxMetricEvaluator(JaxPredictionValueMetric(), [JaxSumValueMetric()],
                                      output_path=str(jax_path))
        want = jax_eval.evaluate(None, evaluation, jax_data)

        assert got.best_idx == want.best_idx == 1
        assert got.best_score.score == pytest.approx(3.0)
        assert got.metric_header == "PredictionValueMetric"
        assert got.other_metric_headers == ["SumValueMetric"]
        assert got.to_one_liner() == want.to_one_liner()
        assert got.to_json() == want.to_json()
        assert got.to_html() == want.to_html()
        assert port_path.read_text() == jax_path.read_text()
        best = json.loads(port_path.read_text())
        assert best["evaluation"] == "SampleEvaluation"
        assert best["algorithmParamsList"][0]["params"]["mult"] == 3
        # best.json binds back to the best grid point
        bound = make_engine().params_from_variant_json(best_json_variant(best))
        assert bound == got.best_engine_params

    def test_ties_keep_the_first_and_nan_never_wins(self):
        evaluation = SampleEvaluation()
        grid = [EngineParams.of(data_source=DSParams(id=1, n_folds=0),
                                algorithms=[("sample", AlgoParams(mult=5))])] + _grid([2, 2])
        result = evaluation.evaluator.evaluate(
            None, evaluation, evaluation.engine.batch_eval(_ctx(), grid))
        assert math.isnan(result.engine_params_scores[0][1].score)
        assert result.best_idx == 1

    def test_empty_grid_raises_as_jax(self):
        with pytest.raises(ValueError, match="empty grid"):
            MetricEvaluator(PredictionValueMetric()).evaluate(None, SampleEvaluation(), [])
        with pytest.raises(ValueError, match="empty grid"):
            JaxMetricEvaluator(JaxPredictionValueMetric()).evaluate(None, SampleEvaluation(), [])


class TestEvaluationBinding:
    def test_unbound_evaluation_raises(self):
        evaluation = Evaluation()
        with pytest.raises(ValueError, match="must set engine_metric"):
            evaluation.engine
        with pytest.raises(ValueError, match="must set engine_metric"):
            evaluation.evaluator
        with pytest.raises(NotImplementedError):
            evaluation.engine_metric
        with pytest.raises(NotImplementedError):
            evaluation.engine_metrics

    def test_binding_styles(self):
        engine = make_engine()
        metric, other = PredictionValueMetric(), SumValueMetric()
        one = Evaluation()
        one.engine_metric = (engine, metric)
        assert one.engine is engine and one.evaluator.metric is metric
        assert one.evaluator.other_metrics == [] and one.evaluator.output_path == "best.json"
        two = Evaluation()
        two.engine_metrics = (engine, metric, [other])
        assert two.evaluator.other_metrics == [other]
        custom = Evaluation()
        evaluator = MetricEvaluator(metric)
        custom.engine_evaluator = (engine, evaluator)
        assert custom.engine_evaluator == (engine, evaluator)

    def test_engine_params_generator(self):
        with pytest.raises(ValueError, match="not set"):
            EngineParamsGenerator().engine_params_list
        gen = EngineParamsGenerator()
        gen.engine_params_list = _grid([1])
        assert gen.engine_params_list == _grid([1])


# ---------------------------------------------------------------------------
# run_evaluation: the instance lifecycle
# ---------------------------------------------------------------------------


class _NoSaveResult(BaseEvaluatorResult):
    no_save = True


class _NoSaveEvaluator(BaseEvaluator):
    def evaluate(self, ctx, evaluation, engine_eval_data_set):
        return _NoSaveResult()


class TestRunEvaluation:
    def test_completed_instance(self):
        ctx = _ctx(batch="nightly")
        outcome = run_evaluation(SampleEvaluation(), EngineParamsGenerator(_grid([1, 2])),
                                 ctx=ctx)
        assert outcome.status == "EVALCOMPLETED"
        instances = ctx.storage.get_meta_data_evaluation_instances()
        inst = instances.get(outcome.instance_id)
        assert inst.status == "EVALCOMPLETED" and inst.batch == "nightly"
        assert inst.evaluation_class.endswith("SampleEvaluation")
        assert inst.engine_params_generator_class.endswith("EngineParamsGenerator")
        assert inst.mesh_conf == {} and inst.env == {}
        assert inst.evaluator_results == outcome.result.to_one_liner()
        assert json.loads(inst.evaluator_results_json)["bestIdx"] == 1
        assert inst.evaluator_results_html == outcome.result.to_html()
        assert inst.completion_time >= inst.start_time
        assert [i.id for i in instances.get_completed()] == [outcome.instance_id]

    def test_spec_strings_resolve(self):
        storage = memory_storage()
        outcome = run_evaluation("tests.test_torch_evaluation.SampleEvaluation",
                                 "tests.test_torch_evaluation:SampleGrid",
                                 storage=storage,
                                 ctx=EngineContext(storage=storage, device="cpu"))
        assert outcome.status == "EVALCOMPLETED" and outcome.result.best_idx == 1
        with pytest.raises(TypeError, match="not an Evaluation"):
            run_evaluation("tests.test_torch_evaluation.SampleGrid", SampleGrid(),
                           ctx=_ctx())

    def test_failure_is_persisted_and_reraised(self):
        ctx = _ctx()
        grid = [EngineParams.of(data_source=DSParams(n_folds=1, fail=True),
                                algorithms=[("sample", AlgoParams())])]
        with pytest.raises(RuntimeError, match="configured to fail"):
            run_evaluation(SampleEvaluation(), EngineParamsGenerator(grid), ctx=ctx)
        (inst,) = ctx.storage.get_meta_data_evaluation_instances().get_all()
        assert inst.status == "FAILED"
        assert inst.evaluator_results == "RuntimeError: datasource configured to fail"
        assert ctx.storage.get_meta_data_evaluation_instances().get_completed() == []

    def test_no_save_leaves_the_instance_at_init(self):
        ctx = _ctx()
        evaluation = Evaluation()
        evaluation.engine_evaluator = (make_engine(), _NoSaveEvaluator())
        outcome = run_evaluation(evaluation, EngineParamsGenerator(_grid([1])), ctx=ctx)
        assert outcome.status == "NOSAVE"
        inst = ctx.storage.get_meta_data_evaluation_instances().get(outcome.instance_id)
        assert inst.status == "INIT" and inst.evaluator_results == ""

    @pytest.mark.parametrize("parallel, env", [(2, None), (None, "2"), (8, "1")])
    def test_parallel_raises_naming_its_item(self, parallel, env, monkeypatch):
        if env is None:
            monkeypatch.delenv("PIO_EVAL_PARALLEL", raising=False)
        else:
            monkeypatch.setenv("PIO_EVAL_PARALLEL", env)
        ctx = _ctx()
        with pytest.raises(NotImplementedError, match=PARALLEL_ITEM):
            run_evaluation(SampleEvaluation(), EngineParamsGenerator(_grid([1])), ctx=ctx,
                           parallel=parallel)
        assert ctx.storage.get_meta_data_evaluation_instances().get_all() == []

    @pytest.mark.parametrize("parallel, env, want", [
        (None, None, 1), (3, "9", 3), (0, None, 1), (None, "4", 4), (None, "x", 1),
        (None, "-2", 1)])
    def test_resolve_parallel(self, parallel, env, want, monkeypatch):
        if env is None:
            monkeypatch.delenv("PIO_EVAL_PARALLEL", raising=False)
        else:
            monkeypatch.setenv("PIO_EVAL_PARALLEL", env)
        assert resolve_parallel(parallel) == want

    def test_evaluation_instances_dao(self):
        from datetime import datetime, timedelta, timezone

        from predictionio_tpu_torch.storage.base import EvaluationInstance

        dao = memory_storage().get_meta_data_evaluation_instances()
        t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
        ids = [dao.insert(EvaluationInstance(id="", status=s, start_time=t0 + timedelta(hours=h),
                                             completion_time=t0))
               for h, s in enumerate(["EVALCOMPLETED", "INIT", "EVALCOMPLETED"])]
        assert dao.insert(EvaluationInstance(id="fixed", status="INIT", start_time=t0,
                                             completion_time=t0)) == "fixed"
        assert [i.id for i in dao.get_completed()] == [ids[2], ids[0]]
        dao.update(dataclasses.replace(dao.get(ids[1]), status="FAILED"))
        assert dao.get(ids[1]).status == "FAILED"
        dao.delete(ids[0])
        assert dao.get(ids[0]) is None and len(dao.get_all()) == 3


# ---------------------------------------------------------------------------
# FastEvalEngine (the JAX package's TestFastEvalEngine)
# ---------------------------------------------------------------------------


class CountingDataSource(SampleDataSource):
    reads = 0

    def read_eval(self, ctx):
        type(self).reads += 1
        return super().read_eval(ctx)


class CountingPreparator(SamplePreparator):
    prepares = 0

    def prepare(self, ctx, td):
        type(self).prepares += 1
        return super().prepare(ctx, td)


class CountingAlgorithm(SampleAlgorithm):
    trains = 0

    def train(self, ctx, pd):
        type(self).trains += 1
        return super().train(ctx, pd)


@pytest.fixture
def counting():
    CountingDataSource.reads = CountingPreparator.prepares = CountingAlgorithm.trains = 0
    return lambda cls=FastEvalEngine: make_engine(cls, CountingDataSource, CountingPreparator,
                                                  CountingAlgorithm)


class TestFastEvalEngine:
    def test_shared_prefixes_are_computed_once(self, counting):
        n_folds = 2
        # 3 grid points sharing the datasource+preparator prefix, 2 distinct
        # algorithm params
        grid = _grid([1, 2, 1])
        results = counting().batch_eval(_ctx(), grid)
        assert len(results) == 3
        assert CountingDataSource.reads == 1
        assert CountingPreparator.prepares == n_folds
        assert CountingAlgorithm.trains == 2 * n_folds
        # results match the plain Engine exactly
        plain = counting(Engine).batch_eval(_ctx(), grid)
        assert results == plain
        assert CountingDataSource.reads == 1 + 3

    def test_distinct_datasource_params_not_shared(self, counting):
        grid = [EngineParams.of(data_source=DSParams(id=i, n_train=4, n_folds=1),
                                algorithms=[("sample", AlgoParams(id=0, mult=1))])
                for i in (1, 2)]
        counting().batch_eval(_ctx(), grid)
        assert CountingDataSource.reads == 2

    def test_serving_params_share_the_models(self, counting):
        """Points that differ only in serving share every prefix up to the
        models, and each still serves through its own serving."""
        ep = _grid([2])[0]
        results = counting().batch_eval(_ctx(), [ep, ep])
        assert CountingAlgorithm.trains == 2 and results[0] == results[1]

    def test_fast_engine_through_run_evaluation_equals_engine(self, counting):
        fast = run_evaluation(SampleEvaluation(counting()), EngineParamsGenerator(
            _grid([1, 3, 1])), ctx=_ctx())
        plain = run_evaluation(SampleEvaluation(make_engine()), EngineParamsGenerator(
            _grid([1, 3, 1])), ctx=_ctx())
        assert fast.result.to_json() == plain.result.to_json()
        assert CountingDataSource.reads == 1
