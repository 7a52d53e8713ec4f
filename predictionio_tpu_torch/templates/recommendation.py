"""Recommendation engine template: ALS over rate/buy events (port of the
JAX package's ``templates/recommendation.py``: train, serve, evaluate).

The data source reads ``rate`` and ``buy`` events into rating triples
(``rate`` takes ``properties.rating``, any other event is worth
``buy_rating``); the preparator indexes the ids densely and collects
each user's seen items; the algorithm trains ``ops/als.als_train`` on
the context's device and answers ``{"user": ..., "num": N}`` (with an
optional ``whiteList``/``blackList``) with the N best unseen items. A
trained model persists as ``models/als.ALSModel.save`` writes it, at the
run's ``checkpoint_location``, behind a ``PersistentModelManifest``.

Evaluation splits the ratings into ``eval_k`` folds (``read_eval``) and
scores Precision@K and MAP@K: ``run_evaluation(RecommendationEvaluation(),
DefaultParamsList(app_name=...))``. The ratings are read through the
columnar ``EventStore.scan``, as the JAX template reads them.

Usage (engine.json):
    {"engineFactory":
       "predictionio_tpu_torch.templates.recommendation.engine_factory",
     "datasource": {"params": {"appName": "MyApp"}},
     "algorithms": [{"name": "als",
                     "params": {"rank": 10, "numIterations": 10,
                                "lambda": 0.01, "seed": 3}}]}
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from predictionio_tpu_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    EngineParams,
    EngineParamsGenerator,
    Evaluation,
    FirstServing,
    MetricEvaluator,
    OptionAverageMetric,
    Params,
    PersistentModelManifest,
    Preparator,
    SanityCheck,
)
from predictionio_tpu_torch.controller.persistent_model import checkpoint_location
from predictionio_tpu_torch.models.als import ALSModel, build_allow_vector
from predictionio_tpu_torch.ops import topk as topk_ops
from predictionio_tpu_torch.ops.als import RatingsCOO, als_train, resolve_shard_factors
from predictionio_tpu_torch.utils.bimap import EntityIdIxMap

@dataclasses.dataclass(frozen=True)
class Query:
    """{user, num} plus optional id filters: ``white_list`` None = no
    restriction, () = nothing eligible; ``black_list`` always excluded."""

    user: str
    num: int = 10
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
class TrainingData(SanityCheck):
    """Raw (user, item, rating) triples as host arrays."""

    users: np.ndarray
    items: np.ndarray
    ratings: np.ndarray

    def sanity_check(self) -> None:
        if len(self.users) == 0:
            raise ValueError("ratings are empty; ingest rate/buy events first "
                             "(reference DataSource.scala sanity: train with events)")


@dataclasses.dataclass(frozen=True)
class PreparedData:
    """Dense-index ratings, the id maps and each user's seen items."""

    coo: RatingsCOO
    user_ids: EntityIdIxMap
    item_ids: EntityIdIxMap
    seen_by_user: dict[int, np.ndarray]


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    """The JAX template's fields, so one engine.json binds to both
    (``eval_*`` and ``seed`` are read by ``read_eval`` alone)."""

    app_name: str = ""
    event_names: tuple = ("rate", "buy")
    buy_rating: float = 4.0
    entity_type: str = "user"
    target_entity_type: str = "item"
    eval_k: int = 0
    eval_query_num: int = 10
    seed: int = 3


def ratings_from_columns(cols, buy_rating: float):
    """One EventColumns batch → (users, items, ratings) arrays, or None
    when nothing survives (the JAX template's function): rows need a
    target entity, ``rate`` events take their properties' ``rating``
    (rows whose rating is missing or not a number are dropped), any
    other event is worth ``buy_rating``."""
    n = len(cols)
    if n == 0:
        return None
    none_code = cols.target_entity_id.code_of(None)
    keep = np.ones(n, dtype=bool)
    if none_code is not None:
        keep &= cols.target_entity_id.codes != none_code
    ratings = np.full(n, buy_rating, dtype=np.float32)
    rate_code = cols.event.code_of("rate")
    if rate_code is not None:
        for i in np.nonzero(keep & (cols.event.codes == rate_code))[0]:
            try:
                ratings[i] = float(cols.properties_raw(int(i)).get("rating"))
            except (KeyError, TypeError, ValueError):
                keep[i] = False
    idx = np.nonzero(keep)[0]
    if len(idx) == 0:
        return None
    return cols.entity_id.decode()[idx], cols.target_entity_id.decode()[idx], ratings[idx]


class RecommendationDataSource(DataSource):
    """Reads rate/buy events into rating triples, in store order, through
    the columnar ``EventStore.scan`` (:func:`ratings_from_columns` per
    batch); duplicates are kept."""

    params_class = DataSourceParams

    def read_training(self, ctx: Any) -> TrainingData:
        p = self.params
        parts = [part for cols in ctx.event_store().scan(
                     p.app_name, entity_type=p.entity_type, event_names=list(p.event_names),
                     target_entity_type=p.target_entity_type)
                 if (part := ratings_from_columns(cols, p.buy_rating)) is not None]
        if not parts:
            empty = np.asarray([], dtype=object)
            return TrainingData(users=empty, items=empty.copy(),
                                ratings=np.asarray([], dtype=np.float32))
        users, items, ratings = (np.concatenate(col) for col in zip(*parts))
        return TrainingData(users=users, items=items, ratings=ratings)

    def read_eval(self, ctx: Any) -> list:
        """``eval_k`` folds over the ratings in store order: rating j falls
        in fold ``np.random.default_rng(seed).integers(0, eval_k, n)[j]``,
        so the same events split as the JAX template splits them. Fold
        k trains on the other folds' ratings; its queries are its users
        in sorted order ({user, num: eval_query_num}), each answered by
        the tuple of its items in the fold."""
        p = self.params
        full = self.read_training(ctx)
        fold_of = np.random.default_rng(p.seed).integers(0, p.eval_k, size=len(full.users))
        folds = []
        for k in range(p.eval_k):
            test = fold_of == k
            td = TrainingData(users=full.users[~test], items=full.items[~test],
                              ratings=full.ratings[~test])
            by_user: dict[str, list[str]] = {}
            for u, i in zip(full.users[test], full.items[test]):
                by_user.setdefault(u, []).append(i)
            qa = [(Query(user=u, num=p.eval_query_num), tuple(items))
                  for u, items in sorted(by_user.items())]
            folds.append((td, {"fold": k}, qa))
        return folds


class ALSPreparator(Preparator):
    """String ids → dense indices (first-seen order) and COO ratings."""

    def prepare(self, ctx: Any, td: TrainingData) -> PreparedData:
        user_ids = EntityIdIxMap.from_ids(td.users)
        item_ids = EntityIdIxMap.from_ids(td.items)
        rows = user_ids.to_index(td.users)
        cols = item_ids.to_index(td.items)
        seen: dict[int, set[int]] = {}
        for r, c in zip(rows, cols):
            seen.setdefault(int(r), set()).add(int(c))
        return PreparedData(
            coo=RatingsCOO(rows=rows, cols=cols,
                           vals=np.asarray(td.ratings, dtype=np.float32),
                           num_rows=len(user_ids), num_cols=len(item_ids)),
            user_ids=user_ids,
            item_ids=item_ids,
            seen_by_user={u: np.asarray(sorted(s), dtype=np.int32) for u, s in seen.items()})


@dataclasses.dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    """The JAX template's fields (engine.json ``"lambda"`` binds to
    ``lambda_``). ``use_mesh`` trains over the context's mesh when it
    spans several positions (``ctx.mesh_if_parallel``); ``shard_factors``
    (engine.json ``"shardFactors"``; ``PIO_TRAIN_SHARD_FACTORS=1``/``0``
    overrides it) row-shards both factor tables over the mesh's "model"
    axis (DP×MP), and the model saved then restores sharded."""

    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    seed: int = 3
    implicit_prefs: bool = False
    alpha: float = 1.0
    use_mesh: bool = True
    exclude_seen: bool = True
    shard_factors: bool = False


class ALSAlgorithm(Algorithm):
    """ALS matrix factorization on the context's device; queries through
    the masked top-k."""

    params_class = ALSAlgorithmParams
    query_class = Query

    def train(self, ctx: Any, pd: PreparedData) -> ALSModel:
        p = self.params
        factors = als_train(pd.coo, rank=p.rank, iterations=p.num_iterations,
                            lam=p.lambda_, implicit=p.implicit_prefs, alpha=p.alpha,
                            seed=p.seed, mesh=ctx.mesh_if_parallel if p.use_mesh else None,
                            shard_factors=resolve_shard_factors(p.shard_factors),
                            device=ctx.device)
        return ALSModel(rank=p.rank, user_factors=factors.user, item_factors=factors.item,
                        user_ids=pd.user_ids, item_ids=pd.item_ids,
                        seen_by_user=pd.seen_by_user)

    def predict(self, model: ALSModel, query: Query) -> PredictedResult:
        recs = model.recommend(
            query.user, query.num,
            allow=build_allow_vector(model.item_ids, white_list=query.white_list,
                                     black_list=query.black_list),
            exclude_seen=self.params.exclude_seen)
        return PredictedResult(item_scores=tuple(ItemScore(item=i, score=s) for i, s in recs))

    def batch_predict(self, model: ALSModel, queries):
        """Unfiltered queries of known users in one batched top-k; queries
        with a white or black list take the single path (each needs its
        own allow vector), unknown users get an empty answer. The seen
        arrays pad to the ``_SEEN_WIDTHS`` menu (a longer history to the
        next power of two: never truncated), the batch to
        ``serving_batch``."""
        if not queries:
            return []

        def single_path(q: Query) -> bool:
            return (q.white_list is not None or bool(q.black_list)
                    or model.needs_online_path(q.user))

        out = [(qi, self.predict(model, q)) for qi, q in queries if single_path(q)]
        queries = [(qi, q) for qi, q in queries if not single_path(q)]
        known = [(qi, model.user_ids[q.user], q.num) for qi, q in queries
                 if q.user in model.user_ids]
        out += [(qi, PredictedResult()) for qi, q in queries if q.user not in model.user_ids]
        if not known:
            return out
        uixs = np.asarray([u for _, u, _ in known], dtype=np.int32)
        max_num = max(n for _, _, n in known)
        pad = topk_ops._SEEN_WIDTHS[0]
        if self.params.exclude_seen:
            widest = max((len(model.seen_by_user.get(int(u), ())) for _, u, _ in known),
                         default=0)
            for cap in topk_ops._SEEN_WIDTHS:
                pad = cap
                if widest <= cap:
                    break
            while pad < widest:
                pad *= 2
        B = len(known)
        padB = topk_ops.serving_batch(B)
        if padB != B:   # pad rows repeat row 0 and are sliced off
            uixs = np.concatenate([uixs, np.full(padB - B, uixs[0], dtype=np.int32)])
        cols = np.zeros((padB, pad), dtype=np.int32)
        mask = np.zeros((padB, pad), dtype=np.float32)
        if self.params.exclude_seen:
            for j, (_, u, _) in enumerate(known):
                s = model.seen_by_user.get(int(u), np.empty(0, dtype=np.int32))[:pad]
                cols[j, : len(s)] = s
                mask[j, : len(s)] = 1.0
        n_items = model.item_factors.shape[0]
        k = topk_ops.serving_k(min(max_num, n_items), n_items)
        vals, idxs = model.batch_topk(uixs, cols, mask, None, k)
        vals = vals[:B].cpu().numpy()
        idxs = idxs[:B].cpu().numpy()
        inv = model.item_ids.inverse
        for j, (qi, _, num) in enumerate(known):
            scores = []
            for v, i in zip(vals[j][:num], idxs[j][:num]):
                if not np.isfinite(v):
                    break
                scores.append(ItemScore(item=inv[int(i)], score=float(v)))
            out.append((qi, PredictedResult(item_scores=tuple(scores))))
        return out

    def make_persistent_model(self, ctx: Any, model: ALSModel) -> PersistentModelManifest:
        """Saves the model's npz checkpoint (``ALSModel.save``) at the
        run's ``checkpoint_location`` and records a manifest there, as
        the JAX template does."""
        location = checkpoint_location(ctx, "als")
        model.save(location)
        return PersistentModelManifest(
            class_name=f"{type(self).__module__}.{type(self).__qualname__}", location=location)

    def load_model(self, ctx: Any, manifest: PersistentModelManifest) -> ALSModel:
        return ALSModel.load(manifest.location, ctx.device, devices=ctx.devices)


def engine_factory() -> Engine:
    return Engine(
        data_source_class_map=RecommendationDataSource,
        preparator_class_map=ALSPreparator,
        algorithm_class_map={"als": ALSAlgorithm, "": ALSAlgorithm},
        serving_class_map=FirstServing,
    )


class PrecisionAtK(OptionAverageMetric):
    """Hits of the top k in the user's held-out items over
    min(k, |held-out items|); None (left out of the mean) for a user with
    no held-out item, 0.0 for an empty answer."""

    def __init__(self, k: int = 10):
        self.k = k

    @property
    def header(self) -> str:
        return f"Precision@{self.k}"

    def calculate_qpa(self, q: Query, p: PredictedResult, a: tuple) -> float | None:
        relevant = set(a)
        if not relevant:
            return None
        top = [s.item for s in p.item_scores[: self.k]]
        if not top:
            return 0.0
        return sum(1 for item in top if item in relevant) / min(self.k, len(relevant))


class MAPAtK(OptionAverageMetric):
    """Mean average precision at k: the sum of precision@i over the ranks
    i of held-out items within the top k, over min(k, |held-out items|);
    None for a user with no held-out item."""

    def __init__(self, k: int = 10):
        self.k = k

    @property
    def header(self) -> str:
        return f"MAP@{self.k}"

    def calculate_qpa(self, q: Query, p: PredictedResult, a: tuple) -> float | None:
        relevant = set(a)
        if not relevant:
            return None
        hits, precision_sum = 0, 0.0
        for rank, s in enumerate(p.item_scores[: self.k], start=1):
            if s.item in relevant:
                hits += 1
                precision_sum += hits / rank
        return precision_sum / min(self.k, len(relevant))


class RecommendationEvaluation(Evaluation):
    """Precision@k primary, MAP@k secondary, over ``read_eval``'s folds."""

    def __init__(self, k: int = 10, output_path: str | None = "best.json"):
        super().__init__()
        self.engine_evaluator = (
            engine_factory(),
            MetricEvaluator(PrecisionAtK(k=k), other_metrics=[MAPAtK(k=k)],
                            output_path=output_path),
        )


class DefaultParamsList(EngineParamsGenerator):
    """The JAX template's grid: rank {8, 16} × iterations {5, 10}, λ 0.05,
    seed 3."""

    def __init__(self, app_name: str = "RecApp", eval_k: int = 2):
        super().__init__([
            EngineParams.of(
                data_source=DataSourceParams(app_name=app_name, eval_k=eval_k),
                algorithms=[("als", ALSAlgorithmParams(rank=rank, num_iterations=it,
                                                       lambda_=0.05, seed=3))],
            )
            for rank in (8, 16)
            for it in (5, 10)
        ])
