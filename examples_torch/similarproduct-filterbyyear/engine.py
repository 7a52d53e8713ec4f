"""Similarproduct template, filter-by-year variant.

Port of the JAX package's ``examples/similarproduct-filterbyyear``,
itself the reference's filterbyyear variant (reference:
examples/scala-parallel-similarproduct/filterbyyear/): items carry a
required integer ``year`` property read at TRAIN time into the model
(DataSource.scala:88-96 ``properties.get[Int]("year")`` — a missing
year on a $set item fails training, same here), queries add
``recommendFromYear``, candidates must satisfy
``year > recommendFromYear`` (default 1, ALSAlgorithm.scala:247
``getOrElse(1)``), and each returned ItemScore carries the item's
``year`` (ALSAlgorithm.scala:188-193).

Design note: the reference applies the year test per item inside its
ranking loop (isCandidateItem); here, as in the JAX package, the
predicate folds into the dense 0/1 eligibility vector once per query on
the host, so the masked top-k on the factors' device runs unchanged.
Items that were viewed but never ``$set`` (so their year is unknown)
are ineligible at query time: their slot of the index-aligned year
table holds int32's minimum.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from predictionio_tpu_torch.controller import Engine, FirstServing, PersistentModelManifest
from predictionio_tpu_torch.templates.similarproduct import (
    Query,
    SimilarALSAlgorithm,
    SimilarModel,
    SimilarPreparedData,
    SimilarProductDataSource,
    SimilarProductPreparator,
    SimilarTrainingData,
)


@dataclasses.dataclass(frozen=True)
class YearQuery(Query):
    """Parity: filterbyyear Query.scala — base query +
    recommendFromYear."""

    recommend_from_year: int | None = None


@dataclasses.dataclass(frozen=True)
class YearItemScore:
    item: str
    score: float
    year: int


@dataclasses.dataclass(frozen=True)
class YearPredictedResult:
    item_scores: tuple[YearItemScore, ...] = ()


@dataclasses.dataclass(frozen=True)
class YearTrainingData(SimilarTrainingData):
    years: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class YearPreparedData(SimilarPreparedData):
    years: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class YearModel(SimilarModel):
    years: dict = dataclasses.field(default_factory=dict)
    #: index-aligned host year per item (unknown-year items carry a
    #: sentinel below any query year -> never eligible); built once so
    #: predict filters with one vectorized compare, not a per-item loop
    year_by_ix: np.ndarray | None = None

    def __post_init__(self):
        if self.year_by_ix is None:
            arr = np.full(len(self.als.item_ids), np.iinfo(np.int32).min, dtype=np.int64)
            for item_id, year in self.years.items():
                ix = self.als.item_ids.get(item_id)
                if ix is not None:
                    arr[ix] = int(year)
            self.year_by_ix = arr


class FilterByYearDataSource(SimilarProductDataSource):
    """Base view/category read + the required per-item ``year``."""

    def read_training(self, ctx) -> YearTrainingData:
        td = super().read_training(ctx)
        years: dict[str, int] = {}
        props = ctx.event_store().aggregate_properties(self.params.app_name,
                                                        self.params.item_entity_type)
        for item_id, pm in props.items():
            year = pm.get_opt("year")
            if year is None:
                # reference parity: a $set item without a year fails
                # training loudly (DataSource.scala:88-96 throws)
                raise ValueError(f"item {item_id!r} has no 'year' property; "
                                 "filterbyyear requires year on every item")
            years[item_id] = int(year)
        return YearTrainingData(users=td.users, items=td.items, ratings=td.ratings,
                                categories=td.categories, years=years)


class FilterByYearPreparator(SimilarProductPreparator):
    def prepare(self, ctx, td: YearTrainingData) -> YearPreparedData:
        base = super().prepare(ctx, td)
        return YearPreparedData(coo=base.coo, user_ids=base.user_ids, item_ids=base.item_ids,
                                seen_by_user=base.seen_by_user, categories=base.categories,
                                years=td.years)


class FilterByYearAlgorithm(SimilarALSAlgorithm):
    query_class = YearQuery

    def train(self, ctx, pd: YearPreparedData) -> YearModel:
        base = super().train(ctx, pd)
        return YearModel(als=base.als, categories=base.categories, years=pd.years)

    def predict(self, model: YearModel, query: YearQuery) -> YearPredictedResult:
        allow = self._allow_vector(model, query)
        if allow is None:
            allow = np.ones(len(model.als.item_ids), dtype=np.float32)
        # year > recommendFromYear, default 1 (reference
        # ALSAlgorithm.scala:247); unknown-year items carry the
        # sentinel in year_by_ix and are never eligible
        from_year = 1 if query.recommend_from_year is None else int(query.recommend_from_year)
        year_ok = (model.year_by_ix > from_year).astype(np.float32)
        sims = model.als.similar(list(query.items), query.num, allow=allow * year_ok)
        return YearPredictedResult(item_scores=tuple(
            YearItemScore(item=i, score=s, year=model.years[i]) for i, s in sims))

    def make_persistent_model(self, ctx, model: YearModel):
        # the base manifest already names type(self) dynamically
        manifest = super().make_persistent_model(ctx, model)
        with open(os.path.join(manifest.location, "years.json"), "w") as f:
            json.dump(model.years, f)
        return manifest

    def load_model(self, ctx, manifest: PersistentModelManifest) -> YearModel:
        base = super().load_model(ctx, manifest)
        with open(os.path.join(manifest.location, "years.json")) as f:
            years = {k: int(v) for k, v in json.load(f).items()}
        return YearModel(als=base.als, categories=base.categories, years=years)


def engine_factory() -> Engine:
    return Engine(
        data_source_class_map=FilterByYearDataSource,
        preparator_class_map=FilterByYearPreparator,
        algorithm_class_map={"als": FilterByYearAlgorithm},
        serving_class_map=FirstServing,
    )
