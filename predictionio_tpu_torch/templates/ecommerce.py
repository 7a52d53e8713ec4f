"""E-commerce recommendation template: implicit ALS + business rules
(port of the JAX package's ``templates/ecommerce.py``).

The data source reads ``view`` and ``buy`` events (a buy weighs
``buy_weight`` in the confidence) and each item's ``$set``
``categories``; the algorithm trains implicit (Hu-Koren) ALS on the
context's device and answers ``{"user": ..., "num": N}`` (with optional
``categories``, ``whiteList``, ``blackList``) with the N best items after
the rules: seen items (``unseen_only``), the query's lists and
categories, and the ``unavailableItems`` a ``$set`` on the ``constraint``
entity names — read live from the event store at every query, so a
change made after deploy moves the next answer. A user the model does
not know gets the items similar to their recent views, also read live.
Every rule folds into one 0/1 allow vector masked into the top-k.

A deployed engine keeps the context it loaded with, so its queries read
the deploy's store. With ``pio deploy --cache`` a repeated query is
answered from the result cache until its TTL, as in the JAX package: a
constraint changed in the meantime shows from the next miss on.

Usage (engine.json):
    {"engineFactory":
       "predictionio_tpu_torch.templates.ecommerce.engine_factory",
     "datasource": {"params": {"appName": "MyApp"}},
     "algorithms": [{"name": "ecomm", "params": {"appName": "MyApp"}}]}
"""

from __future__ import annotations

import dataclasses
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
from predictionio_tpu_torch.models.als import build_allow_vector
from predictionio_tpu_torch.templates.recommendation import ALSPreparator, TrainingData
from predictionio_tpu_torch.templates.similarproduct import (
    ItemScore,
    PredictedResult,
    SimilarModel,
    SimilarPreparedData,
    load_with_categories,
    read_categories,
    save_with_categories,
    train_als,
)

#: the trained model: the ALS model and the item categories
ECommModel = SimilarModel
ECommPreparedData = SimilarPreparedData


@dataclasses.dataclass(frozen=True)
class Query:
    user: str = ""
    num: int = 10
    categories: tuple | None = None
    white_list: tuple | None = None
    black_list: tuple | None = None


@dataclasses.dataclass(frozen=True)
class ECommTrainingData(SanityCheck):
    users: np.ndarray
    items: np.ndarray
    weights: np.ndarray
    categories: dict  # item id -> tuple of categories

    def sanity_check(self) -> None:
        if len(self.users) == 0:
            raise ValueError("no view/buy events; ingest events first")


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    view_events: tuple = ("view",)
    buy_events: tuple = ("buy",)
    buy_weight: float = 4.0  # buys count more than views in the confidence
    entity_type: str = "user"
    target_entity_type: str = "item"
    item_entity_type: str = "item"


class ECommDataSource(DataSource):
    """Views (weight 1.0) then buys (``buy_weight``), each in store
    order, + item categories."""

    params_class = DataSourceParams

    def read_training(self, ctx: Any) -> ECommTrainingData:
        p = self.params
        store = ctx.event_store()
        users, items, weights = [], [], []
        for names, weight in ((p.view_events, 1.0), (p.buy_events, p.buy_weight)):
            for ev in store.find(p.app_name, entity_type=p.entity_type,
                                 event_names=list(names),
                                 target_entity_type=p.target_entity_type):
                if ev.target_entity_id is None:
                    continue
                users.append(ev.entity_id)
                items.append(ev.target_entity_id)
                weights.append(weight)
        return ECommTrainingData(
            users=np.asarray(users, dtype=object),
            items=np.asarray(items, dtype=object),
            weights=np.asarray(weights, dtype=np.float32),
            categories=read_categories(store, p.app_name, p.item_entity_type))


class ECommPreparator(ALSPreparator):
    def prepare(self, ctx: Any, td: ECommTrainingData) -> ECommPreparedData:
        base = super().prepare(ctx, TrainingData(users=td.users, items=td.items,
                                                 ratings=td.weights))
        return ECommPreparedData(coo=base.coo, user_ids=base.user_ids,
                                 item_ids=base.item_ids, seen_by_user=base.seen_by_user,
                                 categories=td.categories)


@dataclasses.dataclass(frozen=True)
class ECommAlgorithmParams(Params):
    """The JAX template's fields and defaults (``use_mesh`` trains over the
    context's mesh when it spans several positions; ``shard_factors``
    row-shards the factor tables over its "model" axis)."""

    app_name: str = ""
    unseen_only: bool = True
    similar_events: tuple = ("view",)
    unavailable_constraint_entity: str = "constraint"
    unavailable_constraint_id: str = "unavailableItems"
    recent_events_num: int = 10
    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: int = 3
    use_mesh: bool = True
    shard_factors: bool = False


class ECommAlgorithm(ShardedAlgorithm):
    """Implicit ALS + live business-rule filtering: a known user gets
    the filtered personal top-k, an unknown one the items similar to
    their recent views."""

    params_class = ECommAlgorithmParams
    query_class = Query

    def __init__(self, params=None):
        super().__init__(params)
        self._ctx = None

    def train(self, ctx: Any, pd: ECommPreparedData) -> ECommModel:
        self._ctx = ctx
        return ECommModel(als=train_als(ctx, self.params, pd), categories=pd.categories)

    # -- query-time reads ---------------------------------------------------
    def _unavailable_items(self) -> set[str]:
        """The ``items`` of the latest ``$set`` on the constraint entity,
        read now; empty when there is none or the store cannot answer."""
        p = self.params
        if self._ctx is None or not p.app_name:
            return set()
        try:
            events = list(self._ctx.event_store().find_by_entity(
                p.app_name, p.unavailable_constraint_entity, p.unavailable_constraint_id,
                event_names=["$set"], limit=1, latest=True))
        except Exception:
            return set()
        if not events:
            return set()
        items = events[0].properties.get_opt("items")
        return set(items) if items else set()

    def _recent_items(self, user: str) -> list[str]:
        """The user's most recent ``similar_events`` targets, newest
        first (the unknown-user fallback)."""
        p = self.params
        if self._ctx is None or not p.app_name:
            return []
        try:
            events = self._ctx.event_store().find_by_entity(
                p.app_name, "user", user, event_names=list(p.similar_events),
                limit=p.recent_events_num, latest=True)
            return [e.target_entity_id for e in events if e.target_entity_id]
        except Exception:
            return []

    def _allow_vector(self, model: ECommModel, query: Query) -> np.ndarray | None:
        item_ids = model.als.item_ids
        allow = build_allow_vector(item_ids, categories=query.categories,
                                   category_map=model.categories,
                                   white_list=query.white_list, black_list=query.black_list)
        unavailable = self._unavailable_items()
        if allow is None:
            if not unavailable:
                # genuinely unrestricted: None (not an all-ones array)
                # keeps the fast default-allow path AND lets the online
                # overlay's cold-start items merge — an allow vector is
                # catalog-indexed and would force catalog-only serving
                # (the JAX package's models/als._recommend_online)
                return None
            allow = np.ones(len(item_ids), dtype=np.float32)
        for item_id in unavailable:
            ix = item_ids.get(item_id)
            if ix is not None:
                allow[ix] = 0.0
        return allow

    def batch_predict(self, model: ECommModel, queries):
        """Every query needs its own allow vector (categories, lists, the
        live availability), so each takes the single-query path: the base
        map over predict, re-exposed past ShardedAlgorithm's
        must-override guard."""
        return Algorithm.batch_predict(self, model, queries)

    def predict(self, model: ECommModel, query: Query) -> PredictedResult:
        allow = self._allow_vector(model, query)
        als = model.als
        if query.user in als.user_ids or als.online_delta(query.user) is not None:
            recs = als.recommend(query.user, query.num, allow=allow,
                                 exclude_seen=self.params.unseen_only)
        else:
            recent = self._recent_items(query.user)
            recs = als.similar(recent, query.num, allow=allow) if recent else []
        return PredictedResult(item_scores=tuple(ItemScore(item=i, score=s) for i, s in recs))

    def make_persistent_model(self, ctx: Any, model: ECommModel) -> PersistentModelManifest:
        return save_with_categories(ctx, "ecomm", self, model.als, model.categories)

    def load_model(self, ctx: Any, manifest: PersistentModelManifest) -> ECommModel:
        """Keeps ``ctx``: the deployed engine's live reads go to its store."""
        self._ctx = ctx
        als, categories = load_with_categories(ctx, manifest)
        return ECommModel(als=als, categories=categories)


def engine_factory() -> Engine:
    return Engine(
        data_source_class_map=ECommDataSource,
        preparator_class_map=ECommPreparator,
        algorithm_class_map={"ecomm": ECommAlgorithm, "": ECommAlgorithm},
        serving_class_map=FirstServing,
    )
