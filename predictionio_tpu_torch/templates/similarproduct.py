"""Similar-product engine template: implicit ALS item factors + cosine
similarity (port of the JAX package's ``templates/similarproduct.py``).

The data source reads ``view`` events and each item's ``$set``
``categories``; the preparator indexes the ids densely (the
recommendation template's ``ALSPreparator``) and carries the categories
through; the algorithm trains implicit (Hu-Koren) ALS on the context's
device and answers ``{"items": [...], "num": N}`` (with optional
``categories``, ``whiteList``, ``blackList``) with the N items most
cosine-similar to the mean of the query items, through
``models/als.ALSModel.similar`` and the masked top-k of ``ops/topk.py``.
A trained model persists as ``ALSModel.save`` writes it, plus a
``categories.json`` beside it, in the JAX package's format.

Usage (engine.json):
    {"engineFactory":
       "predictionio_tpu_torch.templates.similarproduct.engine_factory",
     "datasource": {"params": {"appName": "MyApp"}},
     "algorithms": [{"name": "als", "params": {"rank": 10}}]}
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np

from predictionio_tpu_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    FirstServing,
    Params,
    PersistentModelManifest,
    SanityCheck,
    ShardedAlgorithm,
)
from predictionio_tpu_torch.controller.persistent_model import checkpoint_location
from predictionio_tpu_torch.models.als import ALSModel, build_allow_vector
from predictionio_tpu_torch.ops.als import RatingsCOO, als_train, resolve_shard_factors
from predictionio_tpu_torch.templates.recommendation import ALSPreparator, TrainingData
from predictionio_tpu_torch.utils.bimap import EntityIdIxMap


@dataclasses.dataclass(frozen=True)
class Query:
    """items, num, categories, whiteList, blackList: ``categories`` or
    ``white_list`` None = no restriction, () = nothing eligible."""

    items: tuple = ()
    num: int = 10
    categories: tuple | None = None
    white_list: tuple | None = None
    black_list: tuple | None = None


@dataclasses.dataclass(frozen=True)
class ItemScore:
    item: str
    score: float


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    item_scores: tuple[ItemScore, ...] = ()


@dataclasses.dataclass(frozen=True)
class SimilarTrainingData(SanityCheck):
    """View pairs (each worth 1.0) + per-item category sets."""

    users: np.ndarray
    items: np.ndarray
    ratings: np.ndarray
    categories: dict  # item id -> tuple of category strings

    def sanity_check(self) -> None:
        if len(self.users) == 0:
            raise ValueError("no view events; ingest user-view-item events first")


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    event_names: tuple = ("view",)
    entity_type: str = "user"
    target_entity_type: str = "item"
    item_entity_type: str = "item"


def read_categories(store, app_name: str, item_entity_type: str) -> dict[str, tuple]:
    """item id -> its ``$set`` ``categories`` (items with none left out)."""
    categories = {}
    for item_id, pm in store.aggregate_properties(app_name, item_entity_type).items():
        cats = pm.get_opt("categories")
        if cats:
            categories[item_id] = tuple(cats)
    return categories


class SimilarProductDataSource(DataSource):
    """Reads view events (in store order) + item categories."""

    params_class = DataSourceParams

    def read_training(self, ctx: Any) -> SimilarTrainingData:
        p = self.params
        store = ctx.event_store()
        users, items = [], []
        for ev in store.find(p.app_name, entity_type=p.entity_type,
                             event_names=list(p.event_names),
                             target_entity_type=p.target_entity_type):
            if ev.target_entity_id is None:
                continue
            users.append(ev.entity_id)
            items.append(ev.target_entity_id)
        return SimilarTrainingData(
            users=np.asarray(users, dtype=object),
            items=np.asarray(items, dtype=object),
            ratings=np.ones(len(users), dtype=np.float32),
            categories=read_categories(store, p.app_name, p.item_entity_type))


@dataclasses.dataclass(frozen=True)
class SimilarPreparedData:
    coo: RatingsCOO
    user_ids: EntityIdIxMap
    item_ids: EntityIdIxMap
    seen_by_user: dict
    categories: dict


class SimilarProductPreparator(ALSPreparator):
    """ALSPreparator + category carry-through."""

    def prepare(self, ctx: Any, td: SimilarTrainingData) -> SimilarPreparedData:
        base = super().prepare(ctx, TrainingData(users=td.users, items=td.items,
                                                 ratings=td.ratings))
        return SimilarPreparedData(coo=base.coo, user_ids=base.user_ids,
                                   item_ids=base.item_ids, seen_by_user=base.seen_by_user,
                                   categories=td.categories)


@dataclasses.dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    """The JAX template's fields and defaults. ``use_mesh`` trains over the
    context's mesh when it spans several positions; ``shard_factors`` (or
    ``PIO_TRAIN_SHARD_FACTORS=1``) row-shards the factor tables over its
    "model" axis."""

    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: int = 3
    use_mesh: bool = True
    shard_factors: bool = False


@dataclasses.dataclass
class SimilarModel:
    """ALSModel + item categories for query-time filtering."""

    als: ALSModel
    categories: dict  # item id -> tuple of categories


def train_als(ctx: Any, p, pd, implicit: bool = True) -> ALSModel:
    """The ALS-family templates' training: ``als_train`` at the params'
    rank, iterations, λ, α and seed on the context's device, or over its
    mesh (``use_mesh``, ``shard_factors``)."""
    factors = als_train(pd.coo, rank=p.rank, iterations=p.num_iterations, lam=p.lambda_,
                        implicit=implicit, alpha=p.alpha, seed=p.seed,
                        mesh=ctx.mesh_if_parallel if p.use_mesh else None,
                        shard_factors=resolve_shard_factors(p.shard_factors),
                        device=ctx.device)
    return ALSModel(rank=p.rank, user_factors=factors.user, item_factors=factors.item,
                    user_ids=pd.user_ids, item_ids=pd.item_ids, seen_by_user=pd.seen_by_user)


def save_with_categories(ctx: Any, prefix: str, algo, als: ALSModel,
                         categories: dict) -> PersistentModelManifest:
    """``ALSModel.save`` at the run's checkpoint location, then
    ``categories.json`` (item id -> list of categories) beside it."""
    location = checkpoint_location(ctx, prefix)
    als.save(location)
    with open(os.path.join(location, "categories.json"), "w") as f:
        json.dump({k: list(v) for k, v in categories.items()}, f)
    return PersistentModelManifest(
        class_name=f"{type(algo).__module__}.{type(algo).__qualname__}", location=location)


def load_with_categories(ctx: Any, manifest: PersistentModelManifest) -> tuple[ALSModel, dict]:
    als = ALSModel.load(manifest.location, ctx.device, devices=ctx.devices)
    with open(os.path.join(manifest.location, "categories.json")) as f:
        categories = {k: tuple(v) for k, v in json.load(f).items()}
    return als, categories


class SimilarALSAlgorithm(ShardedAlgorithm):
    """Implicit ALS; cosine top-k at query time with the category,
    white-list and black-list rules."""

    params_class = ALSAlgorithmParams
    query_class = Query
    #: Hu-Koren confidence weighting; a variant that trains explicit
    #: ALS-WR on rating values flips it
    implicit_prefs = True

    def train(self, ctx: Any, pd: SimilarPreparedData) -> SimilarModel:
        return SimilarModel(als=train_als(ctx, self.params, pd, self.implicit_prefs),
                            categories=pd.categories)

    def _allow_vector(self, model: SimilarModel, query: Query) -> np.ndarray | None:
        """Business-rule eligibility as a dense 0/1 vector (None = no
        restriction), masked into the top-k."""
        return build_allow_vector(model.als.item_ids, categories=query.categories,
                                  category_map=model.categories, white_list=query.white_list,
                                  black_list=query.black_list)

    def batch_predict(self, model: SimilarModel, queries):
        """Queries carry their own item lists and rules, so each takes the
        single-query path (one top-k each): the base map over predict,
        re-exposed past ShardedAlgorithm's must-override guard."""
        return Algorithm.batch_predict(self, model, queries)

    def predict(self, model: SimilarModel, query: Query) -> PredictedResult:
        sims = model.als.similar(list(query.items), query.num,
                                 allow=self._allow_vector(model, query))
        return PredictedResult(item_scores=tuple(ItemScore(item=i, score=s) for i, s in sims))

    def make_persistent_model(self, ctx: Any, model: SimilarModel) -> PersistentModelManifest:
        return save_with_categories(ctx, "simals", self, model.als, model.categories)

    def load_model(self, ctx: Any, manifest: PersistentModelManifest) -> SimilarModel:
        als, categories = load_with_categories(ctx, manifest)
        return SimilarModel(als=als, categories=categories)


def engine_factory() -> Engine:
    return Engine(
        data_source_class_map=SimilarProductDataSource,
        preparator_class_map=SimilarProductPreparator,
        algorithm_class_map={"als": SimilarALSAlgorithm, "": SimilarALSAlgorithm},
        serving_class_map=FirstServing,
    )
