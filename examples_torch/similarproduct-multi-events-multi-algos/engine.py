"""Similarproduct template, multi-events-multi-algos variant.

Port of the JAX package's
``examples/similarproduct-multi-events-multi-algos``, itself the
reference's most instructive similarproduct variant (reference:
examples/scala-parallel-similarproduct/multi/ — "Multiple Events and
Multiple Algorithms"):

- the DataSource reads **two event streams**: "view" events AND
  like/dislike events (DataSource.scala in the variant);
- **two algorithms** train side by side: the standard implicit ALS on
  views, plus a ``LikeAlgorithm`` that trains on like/dislike signals
  where the LATEST event per (user, item) wins and a dislike is a
  high-confidence negative (LikeAlgorithm.scala: like -> 1,
  dislike -> -1 into ``ALS.trainImplicit``; ``ops/als`` implements the
  same c = 1 + α|r|, p = [r > 0] semantics), on the context's device;
- a custom Serving **z-score-standardizes** each algorithm's scores on
  the host and sums them per item before the final top-num cut
  (Serving.scala's meanAndVariance standardization), so neither
  algorithm's score scale dominates the blend.

The port's context carries one device and no mesh: ``use_mesh`` binds
and has no effect, as JAX's ``mesh_if_parallel`` is None on one device.
"""

from __future__ import annotations

import dataclasses
import statistics

import numpy as np

from predictionio_tpu_torch.controller import Engine, SanityCheck, Serving
from predictionio_tpu_torch.models.als import ALSModel
from predictionio_tpu_torch.ops.als import als_train
from predictionio_tpu_torch.templates.recommendation import ALSPreparator, TrainingData
from predictionio_tpu_torch.templates.similarproduct import (
    DataSourceParams,
    ItemScore,
    PredictedResult,
    Query,
    SimilarALSAlgorithm,
    SimilarModel,
    SimilarPreparedData,
    SimilarProductDataSource,
    SimilarProductPreparator,
    SimilarTrainingData,
)


@dataclasses.dataclass(frozen=True)
class MultiTrainingData(SanityCheck):
    """View triples + (deduped, latest-wins) like/dislike triples."""

    views: SimilarTrainingData
    like_users: np.ndarray   # object ids
    like_items: np.ndarray   # object ids
    like_signs: np.ndarray   # float32 +1 (like) / -1 (dislike)

    def sanity_check(self) -> None:
        self.views.sanity_check()
        if len(self.like_users) == 0:
            raise ValueError("no like/dislike events; the LikeAlgorithm needs them")


@dataclasses.dataclass(frozen=True)
class MultiDataSourceParams(DataSourceParams):
    like_event: str = "like"
    dislike_event: str = "dislike"


class MultiDataSource(SimilarProductDataSource):
    """View events via the base template + like/dislike with
    latest-event-wins dedup (the variant's reduceByKey on event time,
    LikeAlgorithm.scala: "An user may like an item and change to
    dislike it later")."""

    params_class = MultiDataSourceParams

    def read_training(self, ctx) -> MultiTrainingData:
        views = super().read_training(ctx)
        p = self.params
        latest: dict[tuple[str, str], tuple] = {}
        for ev in ctx.event_store().find(p.app_name, entity_type=p.entity_type,
                                         event_names=[p.like_event, p.dislike_event],
                                         target_entity_type=p.target_entity_type):
            if ev.target_entity_id is None:
                continue
            key = (ev.entity_id, ev.target_entity_id)
            prev = latest.get(key)
            if prev is None or ev.event_time > prev[0]:
                latest[key] = (ev.event_time, ev.event == p.like_event)
        users = np.asarray([u for u, _ in latest], dtype=object)
        items = np.asarray([i for _, i in latest], dtype=object)
        signs = np.asarray([1.0 if like else -1.0 for _, like in latest.values()],
                           dtype=np.float32)
        return MultiTrainingData(views=views, like_users=users, like_items=items,
                                 like_signs=signs)


@dataclasses.dataclass(frozen=True)
class MultiPreparedData:
    views: SimilarPreparedData
    likes: SimilarPreparedData   # coo.vals carry ±1 signs


class MultiPreparator(SimilarProductPreparator):
    """Prepares both event streams; the like stream gets its own id maps
    (its user/item vocabulary need not match the view stream's)."""

    def prepare(self, ctx, td: MultiTrainingData) -> MultiPreparedData:
        views = super().prepare(ctx, td.views)
        like_base = ALSPreparator.prepare(
            self, ctx, TrainingData(users=td.like_users, items=td.like_items,
                                    ratings=td.like_signs))
        likes = SimilarPreparedData(coo=like_base.coo, user_ids=like_base.user_ids,
                                    item_ids=like_base.item_ids,
                                    seen_by_user=like_base.seen_by_user,
                                    categories=td.views.categories)
        return MultiPreparedData(views=views, likes=likes)


class ViewAlgorithm(SimilarALSAlgorithm):
    """The standard implicit-ALS-on-views algorithm, routed at the view
    half of the multi prepared data."""

    def train(self, ctx, pd: MultiPreparedData) -> SimilarModel:
        return super().train(ctx, pd.views)


class LikeAlgorithm(SimilarALSAlgorithm):
    """Implicit ALS on ±1 like/dislike signals (LikeAlgorithm.scala):
    a dislike trains as confidence 1 + α against preference 0."""

    def train(self, ctx, pd: MultiPreparedData) -> SimilarModel:
        p = self.params
        likes = pd.likes
        factors = als_train(likes.coo, rank=p.rank, iterations=p.num_iterations,
                            lam=p.lambda_, implicit=True, alpha=p.alpha, seed=p.seed,
                            device=ctx.device)
        als = ALSModel(rank=p.rank, user_factors=factors.user, item_factors=factors.item,
                       user_ids=likes.user_ids, item_ids=likes.item_ids,
                       seen_by_user=likes.seen_by_user)
        return SimilarModel(als=als, categories=likes.categories)


class StandardizeServing(Serving):
    """z-score each algorithm's scores, then sum per item (Serving.scala
    in the multi variant: meanAndVariance standardization so the two
    score scales blend fairly; num == 1 queries skip standardization)."""

    def serve(self, query: Query, predictions) -> PredictedResult:
        preds = [p for p in predictions if p.item_scores]
        if not preds:
            return PredictedResult(item_scores=())
        if query.num == 1 or len(preds) == 1:
            standard = [list(p.item_scores) for p in preds]
        else:
            standard = []
            for p in preds:
                scores = [s.score for s in p.item_scores]
                mean = statistics.fmean(scores)
                std = statistics.pstdev(scores) if len(scores) > 1 else 0.0
                standard.append([ItemScore(s.item, 0.0 if std == 0 else (s.score - mean) / std)
                                 for s in p.item_scores])
        combined: dict[str, float] = {}
        for scores in standard:
            for s in scores:
                combined[s.item] = combined.get(s.item, 0.0) + s.score
        top = sorted(combined.items(), key=lambda kv: -kv[1])[: query.num]
        return PredictedResult(item_scores=tuple(ItemScore(item=i, score=v) for i, v in top))


def engine_factory() -> Engine:
    return Engine(
        data_source_class_map=MultiDataSource,
        preparator_class_map=MultiPreparator,
        algorithm_class_map={"als": ViewAlgorithm, "likealgo": LikeAlgorithm},
        serving_class_map=StandardizeServing,
    )
