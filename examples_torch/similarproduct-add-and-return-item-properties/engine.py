"""Similarproduct template, add-and-return-item-properties variant.

Port of the JAX package's
``examples/similarproduct-add-and-return-item-properties``, itself the
reference's add-and-return-item-properties variant (reference:
examples/scala-parallel-similarproduct/add-and-return-item-properties/):
items carry required ``title``, ``date`` and ``imdbUrl`` properties read
at TRAIN time (DataSource.scala:68-75 — a $set item missing one fails
training, same here), and every returned ItemScore is ENRICHED with
them (Engine.scala:35-41, ALSAlgorithm.scala:188-194) so the caller
gets a render-ready result instead of bare item ids.

Design note: the properties ride the model as a host-side dict — they
never touch the device. The cosine top-k runs unchanged on the factors'
device with one host 0/1 vector of catalog length as its allow mask;
enrichment is a dict lookup over the k winners. Items viewed but never
``$set`` have no properties to return and are ineligible at query time
(the reference drops their views at train time instead; the JAX package
keeps the training signal, and so does the port — documented in the
README).
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

REQUIRED_PROPS = ("title", "date", "imdbUrl")


@dataclasses.dataclass(frozen=True)
class RichItemScore:
    """Parity: the variant's ItemScore — item, title, date, imdbUrl,
    score (Engine.scala:35-41)."""

    item: str
    title: str
    date: str
    imdb_url: str
    score: float


@dataclasses.dataclass(frozen=True)
class RichPredictedResult:
    item_scores: tuple[RichItemScore, ...] = ()


@dataclasses.dataclass(frozen=True)
class RichTrainingData(SimilarTrainingData):
    item_props: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class RichPreparedData(SimilarPreparedData):
    item_props: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RichModel(SimilarModel):
    item_props: dict = dataclasses.field(default_factory=dict)
    #: index-aligned host 0/1 "has display properties" vector, built once —
    #: predict multiplies it into the allow mask instead of looping the
    #: catalog per query
    has_props_vec: np.ndarray | None = None

    def __post_init__(self):
        if self.has_props_vec is None:
            vec = np.zeros(len(self.als.item_ids), dtype=np.float32)
            for item_id in self.item_props:
                ix = self.als.item_ids.get(item_id)
                if ix is not None:
                    vec[ix] = 1.0
            self.has_props_vec = vec


class RichItemDataSource(SimilarProductDataSource):
    """Base view/category read + the required item display properties."""

    def read_training(self, ctx) -> RichTrainingData:
        td = super().read_training(ctx)
        item_props: dict[str, dict] = {}
        props = ctx.event_store().aggregate_properties(self.params.app_name,
                                                        self.params.item_entity_type)
        for item_id, pm in props.items():
            entry = {}
            for name in REQUIRED_PROPS:
                value = pm.get_opt(name)
                if value is None:
                    # reference parity: DataSource.scala:68-75 throws on
                    # a $set item missing a required property
                    raise ValueError(
                        f"item {item_id!r} has no {name!r} property; this variant "
                        "requires title/date/imdbUrl on every item")
                entry[name] = str(value)
            item_props[item_id] = entry
        return RichTrainingData(users=td.users, items=td.items, ratings=td.ratings,
                                categories=td.categories, item_props=item_props)


class RichItemPreparator(SimilarProductPreparator):
    def prepare(self, ctx, td: RichTrainingData) -> RichPreparedData:
        base = super().prepare(ctx, td)
        return RichPreparedData(coo=base.coo, user_ids=base.user_ids, item_ids=base.item_ids,
                                seen_by_user=base.seen_by_user, categories=base.categories,
                                item_props=td.item_props)


class RichItemAlgorithm(SimilarALSAlgorithm):
    query_class = Query

    def train(self, ctx, pd: RichPreparedData) -> RichModel:
        base = super().train(ctx, pd)
        return RichModel(als=base.als, categories=base.categories, item_props=pd.item_props)

    def predict(self, model: RichModel, query: Query) -> RichPredictedResult:
        allow = self._allow_vector(model, query)
        if allow is None:
            allow = np.ones(len(model.als.item_ids), dtype=np.float32)
        # only items with known properties can be returned enriched
        sims = model.als.similar(list(query.items), query.num,
                                 allow=allow * model.has_props_vec)
        scores = []
        for item, score in sims:
            props = model.item_props[item]
            scores.append(RichItemScore(item=item, title=props["title"], date=props["date"],
                                        imdb_url=props["imdbUrl"], score=score))
        return RichPredictedResult(item_scores=tuple(scores))

    def make_persistent_model(self, ctx, model: RichModel):
        # the base manifest already names type(self) dynamically
        manifest = super().make_persistent_model(ctx, model)
        with open(os.path.join(manifest.location, "item_props.json"), "w") as f:
            json.dump(model.item_props, f)
        return manifest

    def load_model(self, ctx, manifest: PersistentModelManifest) -> RichModel:
        base = super().load_model(ctx, manifest)
        with open(os.path.join(manifest.location, "item_props.json")) as f:
            item_props = json.load(f)
        return RichModel(als=base.als, categories=base.categories, item_props=item_props)


def engine_factory() -> Engine:
    return Engine(
        data_source_class_map=RichItemDataSource,
        preparator_class_map=RichItemPreparator,
        algorithm_class_map={"als": RichItemAlgorithm},
        serving_class_map=FirstServing,
    )
