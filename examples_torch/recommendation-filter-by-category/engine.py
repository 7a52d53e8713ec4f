"""Recommendation template + category filtering: rating-based ALS whose
queries carry a ``categories`` field, with results restricted to items
in ANY of the requested categories.

Port of the JAX package's ``examples/recommendation-filter-by-category``,
itself the reference's filter-by-category variant (reference:
examples/scala-parallel-recommendation/filter-by-category/src/main/scala/
{DataSource,ALSAlgorithm}.scala): items gain categories from their
``$set`` events, the Query grows a ``categories`` array, and the
eligibility filter applies BEFORE top-k, so the caller always gets
``num`` in-category results when enough exist (vs post-filtering, which
can under-fill). Composes entirely from the port's pieces: the
recommendation template's DataSource/Preparator/ALS plus the shared
``build_allow_vector`` business-rule helper; the 0/1 vector is built on
the host and masked into the top-k on the factors' device.

The trained model persists as a pickle blob, as in the JAX example: the
port's persistence moves the ALS factor tables to host arrays and puts
them back on the deploy's device (``workflow/persistence.load_models``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from predictionio_tpu_torch.controller import Engine, FirstServing
from predictionio_tpu_torch.models.als import ALSModel, build_allow_vector
from predictionio_tpu_torch.templates.recommendation import (
    ALSAlgorithm,
    ALSPreparator,
    DataSourceParams,
    ItemScore,
    PredictedResult,
    RecommendationDataSource,
    TrainingData,
)


@dataclasses.dataclass(frozen=True)
class Query:
    """user + num + categories (Engine.scala:26 of the variant)."""

    user: str
    num: int = 10
    categories: tuple | None = None


@dataclasses.dataclass(frozen=True)
class CategoryTrainingData(TrainingData):
    categories: dict = dataclasses.field(default_factory=dict)


class CategoryDataSource(RecommendationDataSource):
    """Rate events + item ``$set`` ``categories`` properties
    (DataSource.scala:51 of the variant)."""

    params_class = DataSourceParams

    def read_eval(self, ctx):
        # like the reference variant (only readTraining is implemented):
        # the base read_eval would yield category-less folds and base
        # Query objects, which this engine's components can't consume
        raise NotImplementedError(
            "the filter-by-category example does not implement read_eval; "
            "evaluate the base recommendation template instead")

    def read_training(self, ctx) -> CategoryTrainingData:
        td = super().read_training(ctx)
        p = self.params
        categories: dict[str, tuple] = {}
        for item_id, pm in ctx.event_store().aggregate_properties(
                p.app_name, p.target_entity_type).items():
            cats = pm.get_opt("categories")
            if cats:
                categories[item_id] = tuple(cats)
        return CategoryTrainingData(users=td.users, items=td.items, ratings=td.ratings,
                                    categories=categories)


@dataclasses.dataclass(frozen=True)
class CategoryPreparedData:
    coo: object
    user_ids: object
    item_ids: object
    seen_by_user: dict
    categories: dict


class CategoryPreparator(ALSPreparator):
    def prepare(self, ctx, td: CategoryTrainingData) -> CategoryPreparedData:
        pd = super().prepare(ctx, td)
        return CategoryPreparedData(coo=pd.coo, user_ids=pd.user_ids, item_ids=pd.item_ids,
                                    seen_by_user=pd.seen_by_user, categories=td.categories)


@dataclasses.dataclass
class CategoryModel:
    """ALSModel + the item->categories map for query-time filtering."""

    als: ALSModel
    categories: dict


class CategoryALSAlgorithm(ALSAlgorithm):
    query_class = Query

    def train(self, ctx, pd: CategoryPreparedData) -> CategoryModel:
        return CategoryModel(als=super().train(ctx, pd), categories=pd.categories)

    def predict(self, model: CategoryModel, query: Query) -> PredictedResult:
        allow = build_allow_vector(model.als.item_ids, categories=query.categories,
                                   category_map=model.categories)
        recs = model.als.recommend(query.user, query.num,
                                   allow=None if allow is None else np.asarray(allow),
                                   exclude_seen=self.params.exclude_seen)
        return PredictedResult(item_scores=tuple(ItemScore(item=i, score=s) for i, s in recs))

    def batch_predict(self, model: CategoryModel, queries):
        # per-query category filters need per-query allow vectors — the
        # single-query path handles each (fine at example scale)
        return [(qi, self.predict(model, q)) for qi, q in queries]

    def make_persistent_model(self, ctx, model: CategoryModel):
        return model  # pickle blob (example scale)


def engine_factory() -> Engine:
    return Engine(
        data_source_class_map=CategoryDataSource,
        preparator_class_map=CategoryPreparator,
        algorithm_class_map={"als": CategoryALSAlgorithm},
        serving_class_map=FirstServing,
    )
