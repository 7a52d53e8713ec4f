"""Classification engine template: naive Bayes and logistic regression
over entity properties (port of the JAX package's
``templates/classification.py``).

The data source reads each entity's ``$set`` properties (numeric
``attrs`` + a categorical ``label``) through ``aggregate_properties``
with ``required=``; the algorithms train ``models/naive_bayes`` and
``models/logreg`` on the context's device and answer ``{"attrs": [...]}``
with the predicted label and per-label log posteriors (log-softmax), so
``BlendedServing`` can average the two learners. Evaluation: k-fold
``read_eval`` and the ``Accuracy`` metric over the smoothing grid of
``DefaultParamsList``, through ``workflow/evaluation.run_evaluation``.

Usage (engine.json):
    {"engineFactory":
       "predictionio_tpu_torch.templates.classification.engine_factory",
     "datasource": {"params": {"appName": "MyApp",
                               "attrs": ["attr0", "attr1", "attr2"],
                               "label": "plan"}},
     "algorithms": [{"name": "naive", "params": {"smoothing": 1.0}}]}
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.controller import (
    AverageMetric,
    DataSource,
    Engine,
    EngineParams,
    EngineParamsGenerator,
    Evaluation,
    FirstServing,
    HostModelAlgorithm,
    IdentityPreparator,
    MetricEvaluator,
    Params,
    SanityCheck,
)
from predictionio_tpu_torch.models import logreg, naive_bayes
from predictionio_tpu_torch.utils.bimap import BiMap


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    attrs: tuple = ("attr0", "attr1", "attr2")
    label: str = "plan"
    entity_type: str = "user"
    eval_k: int = 0  # >0 enables k-fold read_eval


@dataclasses.dataclass(frozen=True)
class TrainingData(SanityCheck):
    """Dense features (N, F) + integer labels (N,) + label vocabulary."""

    features: np.ndarray
    labels: np.ndarray
    label_map: BiMap

    def sanity_check(self) -> None:
        if len(self.features) == 0:
            raise ValueError(
                "training data is empty; ingest $set events with attr/label "
                "properties first")
        if len(self.features) != len(self.labels):
            raise ValueError("features/labels length mismatch")


@dataclasses.dataclass(frozen=True)
class Query:
    attrs: Sequence[float]


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    label: str
    scores: dict


class ClassificationDataSource(DataSource):
    """Aggregated entity properties → dense arrays, entities in sorted id
    order, labels indexed in sorted label order."""

    params_class = DataSourceParams

    def _read(self, ctx: Any) -> TrainingData:
        p = self.params
        props = ctx.event_store().aggregate_properties(
            p.app_name, p.entity_type, required=list(p.attrs) + [p.label])
        rows, labels = [], []
        for _, pm in sorted(props.items()):
            rows.append([pm.get(a, float) for a in p.attrs])
            labels.append(str(pm.get(p.label)))
        label_map = BiMap.string_int(sorted(set(labels)))
        return TrainingData(
            features=np.asarray(rows, dtype=np.float32).reshape(len(rows), len(p.attrs)),
            labels=np.asarray([label_map[lab] for lab in labels], dtype=np.int32),
            label_map=label_map)

    def read_training(self, ctx: Any) -> TrainingData:
        return self._read(ctx)

    def read_eval(self, ctx: Any) -> list:
        """``eval_k`` folds by row index: fold k tests rows i with
        ``i % eval_k == k`` ({attrs} against the held-out label) and
        trains on the rest."""
        p = self.params
        full = self._read(ctx)
        inv = full.label_map.inverse
        idx = np.arange(len(full.labels))
        folds = []
        for k in range(p.eval_k):
            test = (idx % p.eval_k) == k
            td = TrainingData(features=full.features[~test], labels=full.labels[~test],
                              label_map=full.label_map)
            qa = [(Query(attrs=tuple(map(float, full.features[i]))), inv[int(full.labels[i])])
                  for i in np.nonzero(test)[0]]
            folds.append((td, {"fold": k}, qa))
        return folds


@dataclasses.dataclass(frozen=True)
class AlgorithmParams(Params):
    """``use_mesh`` counts over the context's mesh (rows split over its
    "data" axis) when it spans several positions."""

    smoothing: float = 1.0
    use_mesh: bool = True


@dataclasses.dataclass
class NBModel:
    nb: naive_bayes.MultinomialNBModel
    label_map: BiMap


def _results_from_log_probs(queries, log_probs: torch.Tensor, label_map: BiMap):
    """(index, PredictedResult) pairs from an (N, C) matrix of per-label
    log probabilities, read to the host once."""
    rows = log_probs.cpu().numpy()
    best = rows.argmax(axis=1)
    inv = label_map.inverse
    return [(i, PredictedResult(label=inv[int(b)],
                                scores={inv[c]: float(s) for c, s in enumerate(row)}))
            for (i, _), b, row in zip(queries, best, rows)]


def _query_features(queries, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray([list(q.attrs) for _, q in queries], dtype=np.float32),
                           device=device)


class NaiveBayesAlgorithm(HostModelAlgorithm):
    """MLlib ``NaiveBayes.train`` → ``models/naive_bayes.train_multinomial``
    on the context's device, or over its mesh (``use_mesh``)."""

    params_class = AlgorithmParams
    query_class = Query

    def train(self, ctx: Any, pd: TrainingData) -> NBModel:
        nb = naive_bayes.train_multinomial(pd.features, pd.labels,
                                           num_classes=len(pd.label_map),
                                           smoothing=self.params.smoothing,
                                           mesh=ctx.mesh_if_parallel if self.params.use_mesh
                                           else None, device=ctx.device)
        return NBModel(nb=nb, label_map=pd.label_map)

    def predict(self, model: NBModel, query: Query) -> PredictedResult:
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(self, model: NBModel, queries):
        if not queries:
            return []
        nb = model.nb
        scores = naive_bayes.predict_multinomial_scores(
            nb.log_prior, nb.log_theta, _query_features(queries, nb.log_prior.device))
        # the log-joint normalized to per-label log posteriors, so scores
        # compare across algorithms (BlendedServing averages them with
        # logreg's log_softmax outputs; argmax is unchanged)
        return _results_from_log_probs(queries, torch.log_softmax(scores, dim=1),
                                       model.label_map)


@dataclasses.dataclass(frozen=True)
class LogRegAlgorithmParams(Params):
    iterations: int = 300
    lr: float = 0.1
    l2: float = 1e-4
    use_mesh: bool = True


@dataclasses.dataclass
class LRModel:
    lr: logreg.LogRegModel
    label_map: BiMap


class LogisticRegressionAlgorithm(HostModelAlgorithm):
    """The second learner (the reference's add-algorithm variant), with
    NaiveBayesAlgorithm's Query/PredictedResult so both serve in one
    engine."""

    params_class = LogRegAlgorithmParams
    query_class = Query

    def train(self, ctx: Any, pd: TrainingData) -> LRModel:
        p = self.params
        model = logreg.train_logreg(pd.features, pd.labels, num_classes=len(pd.label_map),
                                    l2=p.l2, iterations=p.iterations, lr=p.lr,
                                    mesh=ctx.mesh_if_parallel if p.use_mesh else None,
                                    device=ctx.device)
        return LRModel(lr=model, label_map=pd.label_map)

    def predict(self, model: LRModel, query: Query) -> PredictedResult:
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(self, model: LRModel, queries):
        if not queries:
            return []
        W = model.lr.weights
        scores = logreg.predict_logreg_scores(W, _query_features(queries, W.device))
        return _results_from_log_probs(queries, scores, model.label_map)


class BlendedServing(FirstServing):
    """Average the per-label scores across algorithms and re-argmax (the
    first prediction when only one algorithm serves)."""

    def serve(self, query: Query, predictions) -> PredictedResult:
        if len(predictions) == 1:
            return predictions[0]
        blended: dict[str, float] = {}
        for pred in predictions:
            for label, score in pred.scores.items():
                blended[label] = blended.get(label, 0.0) + score / len(predictions)
        if not blended:
            return predictions[0]
        best = max(blended, key=blended.get)
        return PredictedResult(label=best, scores=blended)


def engine_factory() -> Engine:
    return Engine(
        data_source_class_map=ClassificationDataSource,
        preparator_class_map=IdentityPreparator,
        algorithm_class_map={
            "naive": NaiveBayesAlgorithm,
            "logreg": LogisticRegressionAlgorithm,
            "": NaiveBayesAlgorithm,
        },
        serving_class_map={
            "": FirstServing,
            "first": FirstServing,
            "blended": BlendedServing,
        },
    )


# ---------------------------------------------------------------------------
# Evaluation: Accuracy over k-fold splits
# ---------------------------------------------------------------------------


class Accuracy(AverageMetric):
    """1.0 when the predicted label equals the held-out label."""

    def calculate_qpa(self, q, p, a) -> float:
        return 1.0 if p.label == a else 0.0


class ClassificationEvaluation(Evaluation):
    """``run_evaluation(ClassificationEvaluation(), DefaultParamsList(...))``."""

    def __init__(self, output_path: str | None = "best.json"):
        super().__init__()
        self.engine_evaluator = (engine_factory(),
                                 MetricEvaluator(Accuracy(), output_path=output_path))


class DefaultParamsList(EngineParamsGenerator):
    """The JAX template's grid: naive Bayes smoothing {0.5, 1.0, 2.0}."""

    def __init__(self, app_name: str = "ClassApp", eval_k: int = 3,
                 attrs: tuple = ("attr0", "attr1", "attr2"), label: str = "plan"):
        super().__init__([
            EngineParams.of(
                data_source=DataSourceParams(app_name=app_name, attrs=attrs, label=label,
                                             eval_k=eval_k),
                algorithms=[("naive", AlgorithmParams(smoothing=s))],
            )
            for s in (0.5, 1.0, 2.0)
        ])
