"""The port's parallel evaluation grid, FakeRun and `pio eval`
(``predictionio_tpu_torch/experiment/grid.py``, ``workflow/evaluation.py``,
``workflow/fake.py``, ``cli/pio.py``) against the JAX package's on the
CPU: the same grid through both packages' ``run_parallel_grid`` and
``run_evaluation(parallel=N)`` gives equal point docs, best point and
instance rows; one crashed point is one FAILED point; results come back
in grid order whatever the completion order; the partial grid streams
into an EVALUATING row; and `pio eval` prints JAX's messages and exits
with its codes. The sessionrec grid at a small width runs forked and
serially with the same scores.

A FAILED point's error in the port is JAX's text followed by the error
the child raised (``eval worker exited with code 1 (no result
spooled): ValueError: ...``), so the docs are compared with the error
cut to JAX's text, and ``durationS`` left out.
"""

from __future__ import annotations

import dataclasses
import json
import time
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from predictionio_tpu.cli import pio as jax_pio
from predictionio_tpu.controller import EngineParamsGenerator as JaxGenerator
from predictionio_tpu.experiment import grid as jgrid
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.utils.testing import memory_storage as jax_memory_storage
from predictionio_tpu.workflow import cli_commands as jax_cli_commands
from predictionio_tpu.workflow.context import EngineContext as JaxEngineContext
from predictionio_tpu.workflow.evaluation import run_evaluation as jax_run_evaluation
from predictionio_tpu_torch.cli import pio
from predictionio_tpu_torch.controller import (
    AverageMetric,
    EngineParams,
    EngineParamsGenerator,
    Evaluation,
    MetricEvaluator,
)
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.experiment import grid
from predictionio_tpu_torch.storage.base import App
from predictionio_tpu_torch.storage.registry import Storage, memory_storage
from predictionio_tpu_torch.templates import sessionrec
from predictionio_tpu_torch.workflow import fake
from predictionio_tpu_torch.workflow.context import EngineContext
from predictionio_tpu_torch.workflow.evaluation import run_evaluation
from tests import test_experiment_grid as jax_tests
from tests.test_torch_evaluation import (
    AlgoParams,
    DSParams,
    PredictionValueMetric,
    SampleAlgorithm,
    SampleEvaluation,
    make_engine,
)


def _point(mult: int) -> EngineParams:
    return EngineParams.of(data_source=DSParams(id=1, n_train=4, n_folds=2),
                           algorithms=[("sample", AlgoParams(id=0, mult=mult))])


def _poison() -> EngineParams:
    """A point whose eval child dies: no algorithm named 'missing'."""
    return EngineParams.of(data_source=DSParams(id=9, n_train=4, n_folds=2),
                           algorithms=[("missing", AlgoParams(id=0, mult=5))])


def _spec(mults):
    """("p", mult) for a point, ("x",) for the poisoned one, built in
    either package."""
    return [("p", m) if m else ("x",) for m in mults]


def _params(spec, jax=False):
    point, poison = ((jax_tests._point, jax_tests._poison) if jax else (_point, _poison))
    return [point(s[1]) if s[0] == "p" else poison() for s in spec]


def _ctx():
    return EngineContext(storage=memory_storage(), device="cpu")


def _cut(doc: dict, jax_error: str | None = None) -> dict:
    doc = {k: v for k, v in doc.items() if k != "durationS"}
    if "error" in doc and jax_error is not None:
        assert doc["error"].startswith(jax_error)
        doc["error"] = jax_error
    return doc


def _same_points(port_points, jax_points):
    assert len(port_points) == len(jax_points)
    for p, j in zip(port_points, jax_points):
        jdoc = _cut(j.to_doc())
        assert _cut(p.to_doc(), jdoc.get("error")) == jdoc


class SleepyAlgorithm(SampleAlgorithm):
    """Mult 3 answers late, so its point lands after the next one."""

    def batch_predict(self, model, queries):
        if model.mult == 3:
            time.sleep(0.5)
        return super().batch_predict(model, queries)


class TestRunParallelGrid:
    @pytest.mark.parametrize("mults, parallel", [
        ((1, 3, 2), 2), ((1, 0, 2), 3), ((2, 1), 1), ((3, 2, 1, 4), 4)])
    def test_points_and_best_equal_jax(self, mults, parallel):
        spec = _spec(mults)
        jevaluation = jax_tests.SampleEvaluation(jax_tests.make_engine())
        jpoints = jgrid.run_parallel_grid(jevaluation, jevaluation.evaluator,
                                          _params(spec, jax=True), JaxEngineContext(),
                                          parallel)
        evaluation = SampleEvaluation()
        points = grid.run_parallel_grid(evaluation, evaluation.evaluator, _params(spec),
                                        _ctx(), parallel)
        _same_points(points, jpoints)
        want = jgrid.result_from_points(jevaluation.evaluator, _params(spec, jax=True),
                                        jpoints)
        got = grid.result_from_points(evaluation.evaluator, _params(spec), points)
        assert got.best_idx == want.best_idx
        assert json.loads(got.to_json()) == json.loads(want.to_json())

    def test_one_crashed_point_never_kills_the_grid(self):
        evaluation = SampleEvaluation()
        params = [_point(1), _poison(), _point(2)]
        points = grid.run_parallel_grid(evaluation, evaluation.evaluator, params, _ctx(), 3)
        assert [p.status for p in points] == [grid.COMPLETED, grid.FAILED, grid.COMPLETED]
        assert points[1].score is None
        # the exit code, then the error the child raised
        assert points[1].error.startswith("eval worker exited with code 1 (no result spooled)")
        assert "ValueError: algorithms has no component named 'missing'" in points[1].error
        result = grid.result_from_points(evaluation.evaluator, params, points)
        assert result.best_idx == 2 and result.engine_params_scores[1][1].score is None

    def test_all_points_failed_raises(self):
        evaluation = SampleEvaluation()
        params = [_poison(), _poison()]
        points = grid.run_parallel_grid(evaluation, evaluation.evaluator, params, _ctx(), 2)
        assert all(p.status == grid.FAILED for p in points)
        with pytest.raises(RuntimeError, match="every grid point failed"):
            grid.result_from_points(evaluation.evaluator, params, points)

    def test_grid_order_and_streaming_in_completion_order(self):
        engine = make_engine(algo=SleepyAlgorithm)
        evaluation = SampleEvaluation(engine)
        landed = []
        points = grid.run_parallel_grid(
            evaluation, evaluation.evaluator, [_point(3), _point(1), _point(2)], _ctx(), 3,
            on_point=lambda p, done, total: landed.append((p.idx, done, total)))
        assert [p.idx for p in points] == [0, 1, 2]
        assert [p.score for p in points] == pytest.approx([3.0, 1.0, 2.0])
        assert [done for _, done, _ in landed] == [1, 2, 3]
        assert all(total == 3 for _, _, total in landed)
        assert landed[-1][0] == 0  # the slow point landed last

    def test_point_counts_count_both_outcomes(self):
        before = grid.eval_point_counts()
        evaluation = SampleEvaluation()
        grid.run_parallel_grid(evaluation, evaluation.evaluator, [_point(1), _poison()],
                               _ctx(), 2)
        grid.count_sequential_points(2, failed=True)
        after = grid.eval_point_counts()
        assert after[grid.COMPLETED] - before[grid.COMPLETED] == 3
        assert after[grid.FAILED] - before[grid.FAILED] == 2

    @pytest.mark.parametrize("value", [1.5, "text", float("nan"), object()])
    def test_json_safe_equals_jax(self, value):
        got, want = grid._json_safe(value), jgrid._json_safe(value)
        if isinstance(want, str) and want.startswith("<object"):
            assert isinstance(got, str) and got.startswith("<object")
        else:
            assert got == want or (got != got and want != want)

    def test_partial_grid_doc_equals_jax(self):
        points = [grid.GridPointResult(2, grid.FAILED, error="boom", duration_s=0.5),
                  grid.GridPointResult(0, grid.COMPLETED, 1.5, [2.0], duration_s=1.25)]
        jpoints = [jgrid.GridPointResult(**dataclasses.asdict(p)) for p in points]
        assert grid.partial_grid_doc(points, 3) == jgrid.partial_grid_doc(jpoints, 3)

    def test_cuda_initialized_parent_refuses_to_fork(self, monkeypatch):
        """A parent that has initialized CUDA raises before forking
        workers that could not use the card; a CPU grid is not held."""
        import torch

        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)

        class CudaCtx:
            device = torch.device("cuda")

        evaluation = SampleEvaluation()
        with pytest.raises(RuntimeError, match="CUDA is already initialized"):
            grid.run_parallel_grid(evaluation, evaluation.evaluator, [_point(1)], CudaCtx(), 2)
        points = grid.run_parallel_grid(evaluation, evaluation.evaluator, [_point(1)], _ctx(), 2)
        assert points[0].status == grid.COMPLETED


class TestForkSafety:
    def test_device_resolution_leaves_cuda_uninitialized(self, monkeypatch):
        """``resolve_device`` asks NVML (``device_count``), never
        ``is_available``, whose cuInit would leave forked workers unable
        to use the card."""
        import torch

        from predictionio_tpu_torch.utils.device import resolve_device

        def poisons_the_fork():
            raise AssertionError("torch.cuda.is_available() initializes CUDA")

        monkeypatch.setattr(torch.cuda, "is_available", poisons_the_fork)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        assert resolve_device().type == "cuda"
        assert EngineContext(device="cuda").device.type == "cuda"

    def test_a_forked_worker_opens_its_own_sqlite_connections(self, tmp_path):
        """sqlite forbids using a connection across fork: a worker's
        reads go through a pool of its own, and the parent's pooled
        connections stay open and unused in the child."""
        import multiprocessing

        storage = Storage({"PIO_FS_BASEDIR": str(tmp_path)})
        apps = storage.get_meta_data_apps()
        apps.insert(App(0, "A"))
        conn = storage.client_for_source("DEFAULT_SQLITE")._conn
        parent_pool = list(conn._pool.queue)
        assert parent_pool
        out = tmp_path / "child.txt"

        def child():
            names = [a.name for a in apps.get_all()]
            mine = list(conn._pool.queue)
            out.write_text(f"{names} {len(mine)} {any(c in parent_pool for c in mine)} "
                           f"{len(conn._inherited)}")

        p = multiprocessing.get_context("fork").Process(target=child)
        p.start()
        p.join(30)
        assert p.exitcode == 0
        assert out.read_text() == "['A'] 1 False 1"
        # the parent's pool is untouched and still serves
        assert list(conn._pool.queue) == parent_pool and conn._inherited == []
        assert [a.name for a in apps.get_all()] == ["A"]
        storage.close()


class TestRunEvaluationParallel:
    @pytest.mark.parametrize("mults", [(2, 1, 3), (1, 0)])
    def test_instance_rows_equal_jax(self, mults, monkeypatch):
        """The final instance JSON (MetricEvaluatorResult's and the
        point ledger) and every streamed EVALUATING row, against JAX's."""
        spec = _spec(mults)

        def run(jax):
            storage = jax_memory_storage() if jax else memory_storage()
            instances = storage.get_meta_data_evaluation_instances()
            rows = []
            real = instances.update
            monkeypatch.setattr(instances, "update", lambda inst: (
                rows.append((inst.status, inst.evaluator_results_json)), real(inst)))
            if jax:
                outcome = jax_run_evaluation(
                    jax_tests.SampleEvaluation(jax_tests.make_engine()),
                    JaxGenerator(_params(spec, jax=True)), storage=storage, parallel=2)
            else:
                outcome = run_evaluation(SampleEvaluation(),
                                         EngineParamsGenerator(_params(spec)),
                                         storage=storage, ctx=_ctx(), parallel=2)
            return outcome, rows

        (got, got_rows), (want, want_rows) = run(False), run(True)
        assert got.status == want.status == "EVALCOMPLETED"
        assert [s for s, _ in got_rows] == [s for s, _ in want_rows] == (
            ["EVALUATING"] * len(mults) + ["EVALCOMPLETED"])
        for (_, g), (_, w) in zip(got_rows, want_rows):
            g, w = json.loads(g), json.loads(w)
            w["points"] = [_cut(p) for p in w["points"]]
            g["points"] = [_cut(p, j.get("error")) for p, j in zip(g["points"], w["points"])]
            # the mid-run rows list the points in landing order's set
            if "gridDone" in w:
                assert g["gridDone"] == w["gridDone"] and g["gridTotal"] == w["gridTotal"]
                continue
            assert g == w

    def test_all_failed_grid_persists_failed(self):
        ctx = _ctx()
        with pytest.raises(RuntimeError, match="every grid point failed"):
            run_evaluation(SampleEvaluation(), EngineParamsGenerator([_poison(), _poison()]),
                           ctx=ctx, parallel=2)
        (inst,) = ctx.storage.get_meta_data_evaluation_instances().get_all()
        assert inst.status == "FAILED" and "RuntimeError" in inst.evaluator_results

    def test_best_json_written_once_from_the_parent(self, tmp_path):
        out = tmp_path / "best.json"
        outcome = run_evaluation(SampleEvaluation(output_path=str(out)),
                                 EngineParamsGenerator([_point(1), _point(4), _point(2)]),
                                 ctx=_ctx(), parallel=3)
        assert outcome.result.best_idx == 1
        assert json.loads(out.read_text())["algorithmParamsList"][0]["params"]["mult"] == 4

    def test_fake_run_falls_back_sequential_and_keeps_no_save(self):
        """FakeRun's evaluator is not a MetricEvaluator: ``parallel`` is
        ignored, the function sees the context on its device, and the
        instance stays INIT."""
        seen = []
        ctx = _ctx()
        outcome = run_evaluation(fake.FakeRun(lambda c: seen.append(c.device.type)),
                                 fake.FakeEngineParamsGenerator(), ctx=ctx, parallel=4)
        assert seen == ["cpu"] and outcome.status == "NOSAVE"
        assert outcome.result.to_one_liner() == "FakeRun completed"
        assert ctx.storage.get_meta_data_evaluation_instances().get(
            outcome.instance_id).status == "INIT"


# ---------------------------------------------------------------------------
# `pio eval`, held against the JAX package's on tests/cli_eval_support.py
# ---------------------------------------------------------------------------


class ValueMetric(AverageMetric):
    def calculate_qpa(self, q, p, a):
        return float(p.value)


class CliEvaluation(Evaluation):
    """tests/cli_eval_support.CliEvaluation over the port's classes."""

    def __init__(self):
        super().__init__()
        self.engine_evaluator = (make_engine(), MetricEvaluator(ValueMetric()))


class CliParamsList(EngineParamsGenerator):
    def __init__(self):
        super().__init__([
            EngineParams.of(data_source=DSParams(id=1, n_train=4, n_folds=2),
                            algorithms=[("sample", AlgoParams(id=0, mult=m))])
            for m in (1, 2)])


class PoisonedParamsList(EngineParamsGenerator):
    def __init__(self):
        super().__init__([_poison(), _poison()])


class CpuFakeRun(fake.FakeRun):
    def __init__(self):
        super().__init__(lambda ctx: print(f"[INFO] FakeRun on {ctx.device.type}"))


@pytest.fixture
def cli_env(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    for k in list(__import__("os").environ):
        if k.startswith("PIO_STORAGE_") or k == "PIO_EVAL_PARALLEL":
            monkeypatch.delenv(k)
    monkeypatch.chdir(tmp_path)
    JaxStorage.reset_default()
    yield tmp_path
    JaxStorage.reset_default()


def _mask(out: str) -> str:
    return "\n".join("[INFO] Evaluation finished: instance X"
                     if line.startswith("[INFO] Evaluation finished: instance ") else line
                     for line in out.splitlines())


class TestPioEval:
    @pytest.mark.parametrize("flags", [[], ["--parallel", "2"], ["--batch", "nightly"]])
    def test_messages_and_rows_equal_jax(self, cli_env, capsys, flags):
        assert jax_pio.main(["eval", "tests.cli_eval_support.CliEvaluation",
                             "tests.cli_eval_support.CliParamsList", *flags]) == 0
        want = capsys.readouterr().out
        assert pio.main(["eval", "tests.test_torch_experiment_grid.CliEvaluation",
                         "tests.test_torch_experiment_grid.CliParamsList", "--device", "cpu",
                         *flags]) == 0
        got = capsys.readouterr().out
        assert _mask(got) == _mask(want) and "Evaluation finished" in got
        # both packages wrote their rows into the one sqlite store
        rows = Storage().get_meta_data_evaluation_instances().get_all()
        assert [r.status for r in rows] == ["EVALCOMPLETED"] * 2
        assert {r.batch for r in rows} == {"nightly" if "--batch" in flags else ""}
        assert json.loads(rows[0].evaluator_results_json)["bestIdx"] == \
            json.loads(rows[1].evaluator_results_json)["bestIdx"] == 1

    def test_default_generator_is_found_in_the_evaluation_module(self, cli_env, capsys):
        assert type(pio._default_generator(
            "tests.test_torch_experiment_grid.CliEvaluation")).__name__ == "CliParamsList"
        assert type(jax_cli_commands._default_generator(
            "tests.cli_eval_support.CliEvaluation")).__name__ == "CliParamsList"
        assert pio.main(["eval", "tests.test_torch_experiment_grid.CliEvaluation",
                         "--device", "cpu"]) == 0
        assert "[INFO] [2.0]" in capsys.readouterr().out

    def test_no_generator_raises_as_jax(self, cli_env):
        with pytest.raises(ValueError, match="no EngineParamsGenerator found") as got:
            pio._default_generator("predictionio_tpu_torch.controller.base.FirstServing")
        with pytest.raises(ValueError, match="no EngineParamsGenerator found") as want:
            jax_cli_commands._default_generator("predictionio_tpu.controller.base.FirstServing")
        assert str(got.value).replace("_torch", "") == str(want.value)

    def test_failed_grid_exits_1_with_jax_message(self, cli_env, capsys):
        assert pio.main(["eval", "tests.test_torch_experiment_grid.CliEvaluation",
                         "tests.test_torch_experiment_grid.PoisonedParamsList",
                         "--device", "cpu", "--parallel", "2"]) == 1
        out = capsys.readouterr().out
        assert out.startswith("[ERROR] Evaluation failed: every grid point failed: "
                              "[0] eval worker exited with code 1 (no result spooled)")
        (row,) = Storage().get_meta_data_evaluation_instances().get_all()
        assert row.status == "FAILED"

    def test_fake_run_through_pio_eval(self, cli_env, capsys):
        assert pio.main(["eval", "tests.test_torch_experiment_grid.CpuFakeRun",
                         "predictionio_tpu_torch.workflow.fake.FakeEngineParamsGenerator",
                         "--device", "cpu", "--parallel", "2"]) == 0
        out = capsys.readouterr().out
        assert "[INFO] FakeRun on cpu" in out and "[INFO] FakeRun completed" in out
        (row,) = Storage().get_meta_data_evaluation_instances().get_all()
        assert row.status == "INIT"


# ---------------------------------------------------------------------------
# The slice as a whole: sessionrec's grid through forked workers on the CPU
# ---------------------------------------------------------------------------


def _sessionrec_storage():
    rng = np.random.default_rng(0)
    t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
    storage = memory_storage()
    app_id = storage.get_meta_data_apps().insert(App(0, "SessApp"))
    storage.get_events().init(app_id)
    events = []
    for u in range(24):
        # a walk through 30 items that jumps at random every other step
        item = int(rng.integers(30))
        for t in range(8):
            item = (item + 1) % 30 if rng.random() < 0.5 else int(rng.integers(30))
            events.append(Event(event="view", entity_type="user", entity_id=f"u{u}",
                                target_entity_type="item", target_entity_id=f"i{item}",
                                event_time=t0 + timedelta(minutes=100 * u + t),
                                event_id=f"e{u:03d}{t:02d}"))
    storage.get_events().insert_batch(events, app_id)
    return storage


def _sessionrec_grid(n_heads_of_last=2):
    return EngineParamsGenerator([
        EngineParams.of(
            data_source=sessionrec.DataSourceParams(app_name="SessApp", eval_k=2),
            algorithms=[("seqrec", sessionrec.AlgorithmParams(
                d_model=32, n_heads=heads, n_layers=2, max_len=16, batch_size=8, epochs=1,
                lr=lr, seed=0))])
        for lr, heads in ((1e-2, 2), (3e-3, n_heads_of_last))])


class TestSessionrecGrid:
    def test_forked_grid_equals_the_serial_one(self):
        storage = _sessionrec_storage()
        runs = {}
        for parallel in (1, 2):
            ctx = EngineContext(storage=storage, device="cpu")
            runs[parallel] = run_evaluation(sessionrec.SessionRecEvaluation(output_path=None),
                                            _sessionrec_grid(), ctx=ctx, parallel=parallel)
        serial, forked = runs[1].result, runs[2].result
        assert forked.best_idx == serial.best_idx
        assert ([ms.score for _, ms in forked.engine_params_scores]
                == [ms.score for _, ms in serial.engine_params_scores])
        assert all(0.0 < ms.score < 1.0 for _, ms in serial.engine_params_scores)

    def test_a_poisoned_point_fails_alone(self):
        """d_model 32 over 3 heads raises in its child; the other point
        completes and is the best."""
        ctx = EngineContext(storage=_sessionrec_storage(), device="cpu")
        outcome = run_evaluation(sessionrec.SessionRecEvaluation(output_path=None),
                                 _sessionrec_grid(n_heads_of_last=3), ctx=ctx, parallel=2)
        doc = json.loads(ctx.storage.get_meta_data_evaluation_instances().get(
            outcome.instance_id).evaluator_results_json)
        assert [p["status"] for p in doc["points"]] == ["COMPLETED", "FAILED"]
        assert doc["bestIdx"] == 0 and outcome.result.engine_params_scores[1][1].score is None
