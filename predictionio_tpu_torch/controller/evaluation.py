"""Evaluation and parameter tuning: Evaluation, EngineParamsGenerator and
MetricEvaluator (port of the JAX package's ``controller/evaluation.py``,
which holds no device code; copied so the port imports nothing of that
package).

An ``Evaluation`` binds an Engine to an evaluator, usually a
``MetricEvaluator`` over one primary and any number of secondary
metrics; an ``EngineParamsGenerator`` supplies the grid of EngineParams
to search; the evaluator scores every grid point and keeps the best. The
reports (one-liner, JSON, HTML) and ``best.json`` are the same text as
the JAX package writes for the same grid and scores; ``best_json_variant``
turns a ``best.json`` into the engine.json variant it stands for.
"""

from __future__ import annotations

import abc
import dataclasses
import json
import logging
import os
from typing import TYPE_CHECKING, Any, Mapping, Sequence

from predictionio_tpu_torch.controller.metrics import EvalDataSet, Metric
from predictionio_tpu_torch.controller.params import EngineParams, params_to_json

if TYPE_CHECKING:
    from predictionio_tpu_torch.controller.engine import Engine

logger = logging.getLogger(__name__)


class BaseEvaluatorResult(abc.ABC):
    """What an evaluator returns; the workflow persists its renders."""

    #: When True the workflow does not persist the renders.
    no_save: bool = False

    def to_one_liner(self) -> str:
        return ""

    def to_json(self) -> str:
        return ""

    def to_html(self) -> str:
        return ""


class BaseEvaluator(abc.ABC):
    """Scores the evaluation data sets of every grid point."""

    @abc.abstractmethod
    def evaluate(
        self,
        ctx: Any,
        evaluation: "Evaluation",
        engine_eval_data_set: Sequence[tuple[EngineParams, EvalDataSet]],
    ) -> BaseEvaluatorResult:
        ...


@dataclasses.dataclass
class MetricScores:
    """The scores of one grid point."""

    score: Any
    other_scores: list[Any]


@dataclasses.dataclass
class MetricEvaluatorResult(BaseEvaluatorResult):
    best_score: MetricScores
    best_engine_params: EngineParams
    best_idx: int
    metric_header: str
    other_metric_headers: list[str]
    engine_params_scores: list[tuple[EngineParams, MetricScores]]
    output_path: str | None = None

    def to_one_liner(self) -> str:
        best = self.engine_params_scores[self.best_idx][1]
        return f"[{best.score}] {_engine_params_oneline(self.best_engine_params)}"

    def to_json(self) -> str:
        return json.dumps(
            {
                "metricHeader": self.metric_header,
                "otherMetricHeaders": self.other_metric_headers,
                "bestIdx": self.best_idx,
                "bestScore": self.best_score.score,
                "bestEngineParams": _engine_params_json(self.best_engine_params),
                "engineParamsScores": [
                    {
                        "engineParams": _engine_params_json(ep),
                        "score": ms.score,
                        "otherScores": ms.other_scores,
                    }
                    for ep, ms in self.engine_params_scores
                ],
            },
            indent=2,
        )

    def to_html(self) -> str:
        rows = "\n".join(
            "<tr><td>{}</td><td>{}</td><td><pre>{}</pre></td></tr>".format(
                ms.score,
                " ".join(str(s) for s in ms.other_scores),
                json.dumps(_engine_params_json(ep), indent=2),
            )
            for ep, ms in self.engine_params_scores
        )
        return (
            "<h2>Metric: {}</h2><p>Best score: {} (grid point {})</p>"
            "<table border=1><tr><th>{}</th><th>{}</th><th>EngineParams</th></tr>{}</table>"
        ).format(
            self.metric_header,
            self.best_score.score,
            self.best_idx,
            self.metric_header,
            " ".join(self.other_metric_headers),
            rows,
        )


def _engine_params_json(ep: EngineParams) -> dict[str, Any]:
    return {
        "dataSourceParams": {
            "name": ep.data_source_params[0],
            "params": params_to_json(ep.data_source_params[1]),
        },
        "preparatorParams": {
            "name": ep.preparator_params[0],
            "params": params_to_json(ep.preparator_params[1]),
        },
        "algorithmParamsList": [
            {"name": n, "params": params_to_json(p)}
            for n, p in ep.algorithm_params_list
        ],
        "servingParams": {
            "name": ep.serving_params[0],
            "params": params_to_json(ep.serving_params[1]),
        },
    }


def _engine_params_oneline(ep: EngineParams) -> str:
    return json.dumps(_engine_params_json(ep), separators=(",", ":"))


def best_json_variant(doc: Mapping[str, Any]) -> dict[str, Any]:
    """The engine.json variant of a ``best.json``, which
    ``Engine.params_from_variant_json`` binds: ``best.json`` names its
    slots as the JSON report does ("dataSourceParams", ...), an
    engine.json names them "datasource", "preparator", "algorithms" and
    "serving"."""
    return {"datasource": doc["dataSourceParams"], "preparator": doc["preparatorParams"],
            "algorithms": doc["algorithmParamsList"], "serving": doc["servingParams"]}


class MetricEvaluator(BaseEvaluator):
    """Scores every grid point with a primary metric (and any secondary
    metrics), keeps the best by ``metric.compare`` (the first of equal
    scores), and writes ``best.json`` to ``output_path`` when given."""

    def __init__(
        self,
        metric: Metric,
        other_metrics: Sequence[Metric] = (),
        output_path: str | None = None,
    ):
        self.metric = metric
        self.other_metrics = list(other_metrics)
        self.output_path = output_path

    def evaluate(
        self,
        ctx: Any,
        evaluation: "Evaluation",
        engine_eval_data_set: Sequence[tuple[EngineParams, EvalDataSet]],
    ) -> MetricEvaluatorResult:
        scores: list[tuple[EngineParams, MetricScores]] = []
        best_idx = -1
        for idx, (engine_params, eval_data) in enumerate(engine_eval_data_set):
            ms = MetricScores(
                score=self.metric.calculate(eval_data),
                other_scores=[m.calculate(eval_data) for m in self.other_metrics],
            )
            scores.append((engine_params, ms))
            logger.info("grid point %d: %s = %s", idx, self.metric.header, ms.score)
            if best_idx < 0 or self.metric.compare(ms.score, scores[best_idx][1].score) > 0:
                best_idx = idx
        if best_idx < 0:
            raise ValueError("MetricEvaluator.evaluate got an empty grid")

        best_params, best_score = scores[best_idx]
        result = MetricEvaluatorResult(
            best_score=best_score,
            best_engine_params=best_params,
            best_idx=best_idx,
            metric_header=self.metric.header,
            other_metric_headers=[m.header for m in self.other_metrics],
            engine_params_scores=scores,
            output_path=self.output_path,
        )
        if self.output_path:
            self._save_best_json(evaluation, best_params)
        return result

    def _save_best_json(self, evaluation: "Evaluation", ep: EngineParams) -> None:
        """``best.json``: the best EngineParams as an engine.json variant,
        with the evaluation's class name under "evaluation"."""
        payload = _engine_params_json(ep)
        payload["evaluation"] = type(evaluation).__name__
        os.makedirs(os.path.dirname(self.output_path) or ".", exist_ok=True)
        with open(self.output_path, "w") as f:
            json.dump(payload, f, indent=2)
        logger.info("wrote best engine params to %s", self.output_path)


class Evaluation:
    """Binds an engine to its evaluator. A subclass sets one of
    ``engine_metric`` (primary metric only), ``engine_metrics`` (primary
    and others) or ``engine_evaluator`` (any BaseEvaluator) in its
    ``__init__``; the first two write ``best.json`` in the working
    directory."""

    def __init__(self):
        self._engine: "Engine" | None = None
        self._evaluator: BaseEvaluator | None = None

    @property
    def engine_metric(self) -> tuple["Engine", Metric]:
        raise NotImplementedError

    @engine_metric.setter
    def engine_metric(self, value: tuple["Engine", Metric]) -> None:
        engine, metric = value
        self._engine = engine
        self._evaluator = MetricEvaluator(metric, output_path="best.json")

    @property
    def engine_metrics(self) -> tuple["Engine", Metric, Sequence[Metric]]:
        raise NotImplementedError

    @engine_metrics.setter
    def engine_metrics(self, value: tuple["Engine", Metric, Sequence[Metric]]) -> None:
        engine, metric, others = value
        self._engine = engine
        self._evaluator = MetricEvaluator(metric, others, output_path="best.json")

    @property
    def engine_evaluator(self) -> tuple["Engine", BaseEvaluator]:
        if self._engine is None or self._evaluator is None:
            raise ValueError(
                f"{type(self).__name__} must set engine_metric, engine_metrics, "
                "or engine_evaluator in __init__"
            )
        return (self._engine, self._evaluator)

    @engine_evaluator.setter
    def engine_evaluator(self, value: tuple["Engine", BaseEvaluator]) -> None:
        self._engine, self._evaluator = value

    @property
    def engine(self) -> "Engine":
        return self.engine_evaluator[0]

    @property
    def evaluator(self) -> BaseEvaluator:
        return self.engine_evaluator[1]


class EngineParamsGenerator:
    """The grid of EngineParams an evaluation searches."""

    def __init__(self, engine_params_list: Sequence[EngineParams] = ()):
        self._engine_params_list: list[EngineParams] | None = (
            list(engine_params_list) if engine_params_list else None
        )

    @property
    def engine_params_list(self) -> list[EngineParams]:
        if self._engine_params_list is None:
            raise ValueError("engine_params_list is not set")
        return self._engine_params_list

    @engine_params_list.setter
    def engine_params_list(self, value: Sequence[EngineParams]) -> None:
        self._engine_params_list = list(value)
