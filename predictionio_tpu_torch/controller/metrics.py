"""The metric family: per-query scores folded into one result (port of
the JAX package's ``controller/metrics.py``, which holds no device code;
copied so the port imports nothing of that package).

A metric scores an evaluation data set, what ``Engine.eval`` returns for
one EngineParams: per fold ``(EI, [(Q, P, A)])``. The per-query scores
are gathered into one float64 NumPy vector and reduced on the host. The
device work of an evaluation, training and batch prediction, has already
run inside ``Engine.eval``; the reduction is a fold over a few thousand
floats, for which a device round trip would cost more than the sum.
"""

from __future__ import annotations

import abc
import math
from typing import Generic, Sequence, TypeVar

import numpy as np

from predictionio_tpu_torch.controller.base import P, Q

EI = TypeVar("EI")
A = TypeVar("A")
R = TypeVar("R")

#: An evaluation data set: per fold, its evaluation info and the (query,
#: prediction, actual) triples; what Engine.eval returns for one EngineParams.
EvalDataSet = Sequence[tuple[EI, Sequence[tuple[Q, P, A]]]]


class Metric(Generic[EI, Q, P, A, R], abc.ABC):
    """Scores a whole evaluation data set; ``compare`` orders two scores."""

    @abc.abstractmethod
    def calculate(self, eval_data_set: EvalDataSet) -> R:
        """Score the whole evaluation data set."""

    def compare(self, r0: R, r1: R) -> int:
        """Larger is better. NaN (the Average/Stdev score of a grid point
        with no query) always loses, so it is never selected as best."""
        r0_nan = isinstance(r0, float) and math.isnan(r0)
        r1_nan = isinstance(r1, float) and math.isnan(r1)
        if r0_nan or r1_nan:
            return 0 if r0_nan == r1_nan else (-1 if r0_nan else 1)
        if r0 == r1:
            return 0
        return -1 if r0 < r1 else 1

    @property
    def header(self) -> str:
        """Column label in evaluator reports."""
        return type(self).__name__


def _scores(metric: "QPAMetric", eval_data_set: EvalDataSet) -> np.ndarray:
    """Every per-query score of every fold as one float64 vector."""
    vals = [metric.calculate_qpa(q, p, a) for _, qpa in eval_data_set for q, p, a in qpa]
    return np.asarray(vals, dtype=np.float64)


def _option_scores(metric: "QPAMetric", eval_data_set: EvalDataSet) -> np.ndarray:
    """The per-query scores with None dropped."""
    vals = [s for _, qpa in eval_data_set for q, p, a in qpa
            if (s := metric.calculate_qpa(q, p, a)) is not None]
    return np.asarray(vals, dtype=np.float64)


class QPAMetric(Metric[EI, Q, P, A, float], abc.ABC):
    """A metric defined per (query, prediction, actual) triple."""

    @abc.abstractmethod
    def calculate_qpa(self, q: Q, p: P, a: A) -> float | None:
        """Score one query. May return None for the Option* subclasses."""

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        raise NotImplementedError


class AverageMetric(QPAMetric[EI, Q, P, A]):
    """Mean of the per-query scores; NaN when there is none."""

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        s = _scores(self, eval_data_set)
        return float(s.mean()) if s.size else math.nan


class OptionAverageMetric(QPAMetric[EI, Q, P, A]):
    """Mean of the scores that are not None; NaN when there is none."""

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        s = _option_scores(self, eval_data_set)
        return float(s.mean()) if s.size else math.nan


class StdevMetric(QPAMetric[EI, Q, P, A]):
    """Population standard deviation of the scores."""

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        s = _scores(self, eval_data_set)
        return float(s.std()) if s.size else math.nan


class OptionStdevMetric(QPAMetric[EI, Q, P, A]):
    """Population standard deviation of the scores that are not None."""

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        s = _option_scores(self, eval_data_set)
        return float(s.std()) if s.size else math.nan


class SumMetric(QPAMetric[EI, Q, P, A]):
    """Sum of the scores (0.0 for none)."""

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        return float(_scores(self, eval_data_set).sum())


class ZeroMetric(Metric[EI, Q, P, A, float]):
    """Always 0: a placeholder for a required metric slot."""

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        return 0.0
