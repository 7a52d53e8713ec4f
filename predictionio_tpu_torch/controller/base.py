"""DASE component contracts: DataSource, Preparator, Algorithm and
Serving, SanityCheck, and Doer construction (port of the JAX package's
``controller/base.py``, cut to what training, persistence, serving and
evaluation need).

Type vocabulary: TD training data, PD prepared data, Q query, P
predicted result, M model. ``ctx`` is the workflow context
(``workflow/context.EngineContext``); serving never passes one.
"""

from __future__ import annotations

import abc
import dataclasses
import inspect
from typing import Any, Generic, Sequence, TypeVar

from predictionio_tpu_torch.controller.params import EmptyParams

TD = TypeVar("TD")
PD = TypeVar("PD")
Q = TypeVar("Q")
P = TypeVar("P")
M = TypeVar("M")


class Doer:
    """Reflective component construction from params: construct with
    (params) when the __init__ accepts it, else no-arg. Components keep
    their params on ``self.params``."""

    @staticmethod
    def create(cls: type, params: Any = None):
        sig = inspect.signature(cls.__init__)
        if len(sig.parameters) > 1:
            return cls(params if params is not None else EmptyParams())
        instance = cls()
        instance.params = params if params is not None else EmptyParams()
        return instance


class BaseComponent:
    """Common base: stores params, exposes the params class for JSON binding."""

    #: dataclass bound to this component's engine.json "params" object
    params_class: type = EmptyParams

    #: dataclass the /queries.json body binds to (algorithms/servings)
    query_class: type | None = None

    def __init__(self, params: Any = None):
        self.params = params if params is not None else EmptyParams()


class DataSource(BaseComponent, Generic[TD], abc.ABC):
    """Reads training data from the event store."""

    @abc.abstractmethod
    def read_training(self, ctx: Any) -> TD:
        """The training data."""

    def read_eval(self, ctx: Any) -> Sequence[tuple[TD, Any, Sequence[tuple[Q, Any]]]]:
        """Evaluation folds, each ``(training data, evaluation info,
        [(query, actual)])``; none by default."""
        return []


class Preparator(BaseComponent, Generic[TD, PD], abc.ABC):
    """Transforms training data into prepared (model-ready) data."""

    @abc.abstractmethod
    def prepare(self, ctx: Any, td: TD) -> PD:
        """Prepared data for the algorithms."""


class IdentityPreparator(Preparator[TD, TD]):
    """Passes training data through."""

    def prepare(self, ctx: Any, td: TD) -> TD:
        return td


class Algorithm(BaseComponent, Generic[PD, M, Q, P], abc.ABC):
    """Trains a model and answers queries."""

    @abc.abstractmethod
    def train(self, ctx: Any, pd: PD) -> M:
        """The trained model."""

    @abc.abstractmethod
    def predict(self, model: M, query: Q) -> P:
        """Serving-time single query."""

    def batch_predict(self, model: M, queries: Sequence[tuple[int, Q]]) -> Sequence[tuple[int, P]]:
        """Bulk predict over (index, query) pairs. The default maps
        ``predict``; device algorithms override with one batched call."""
        return [(i, self.predict(model, q)) for i, q in queries]

    # -- persistence hooks (the reference's makePersistentModel) ----------
    def make_persistent_model(self, ctx: Any, model: M) -> Any:
        """What the train workflow persists for ``model``: the model
        itself (the default: pickled into the MODELDATA repository,
        tensors moved to host arrays first and back onto the deploy's
        device at load), a
        :class:`PersistentModelManifest` (the algorithm saved the model
        itself, e.g. as a checkpoint directory), or ``None`` (nothing
        persisted: the model is retrained at deploy)."""
        return model

    def load_model(self, ctx: Any, manifest: "PersistentModelManifest") -> M:
        """The model a manifest of :meth:`make_persistent_model` names,
        placed on ``ctx.device``."""
        raise NotImplementedError(
            f"{type(self).__name__} stored a manifest but does not implement load_model")


@dataclasses.dataclass(frozen=True)
class PersistentModelManifest:
    """Stored in place of a model when the algorithm persists the model
    itself: the algorithm's class and where the model lies."""

    class_name: str
    location: str = ""


class Serving(BaseComponent, Generic[Q, P], abc.ABC):
    """Combines per-algorithm predictions into one response."""

    def supplement(self, query: Q) -> Q:
        """Pre-process the query before the algorithms see it."""
        return query

    @abc.abstractmethod
    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        """Receives the ORIGINAL query and one prediction per algorithm."""


class FirstServing(Serving[Q, P]):
    """Serves the first algorithm's prediction."""

    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        return predictions[0]


class SanityCheck(abc.ABC):
    """Data classes may implement this to be checked between pipeline
    stages."""

    @abc.abstractmethod
    def sanity_check(self) -> None:
        """Raise on inconsistent data."""
