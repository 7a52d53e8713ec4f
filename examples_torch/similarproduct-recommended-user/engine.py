"""Similarproduct template, recommended-user variant.

Port of the JAX package's ``examples/similarproduct-recommended-user``,
itself the reference's recommended-user variant (reference:
examples/scala-parallel-similarproduct/recommended-user/): the
similar-product machinery retargeted at a SOCIAL graph — "user follows
user" events train implicit ALS over (follower, followedUser) pairs
(DataSource.scala:55-84, ALSAlgorithm.scala:112-122 `ALS.trainImplicit`),
and queries ask for users most cosine-similar to a set of users
(ALSAlgorithm.scala:157 cosine ranking, query {users, num, whiteList,
blackList}).

The instructive point (and why the reference ships it): the template's
entity types are CONFIGURATION, not structure. Here the port's
similarproduct DataSource/Preparator/Algorithm run UNCHANGED — the
"items" axis simply becomes followed users
(``event_names=("follow",)``, ``target_entity_type="user"``) — and only
a thin Query adapter renames ``items`` to ``users`` for wire parity
with the reference's query JSON.
"""

from __future__ import annotations

import dataclasses

from predictionio_tpu_torch.controller import Engine, FirstServing
from predictionio_tpu_torch.templates.similarproduct import (
    PredictedResult,
    Query,
    SimilarALSAlgorithm,
    SimilarModel,
    SimilarProductDataSource,
    SimilarProductPreparator,
)


@dataclasses.dataclass(frozen=True)
class RecommendedUserQuery:
    """Parity: recommended-user Query.scala — users, num, whiteList,
    blackList (no categories on a social graph)."""

    users: tuple = ()
    num: int = 10
    white_list: tuple | None = None
    black_list: tuple | None = None


class RecommendedUserAlgorithm(SimilarALSAlgorithm):
    """Cosine top-k over FOLLOWED-user factors; the query's own users
    are excluded from results (the reference filters them the same
    way)."""

    query_class = RecommendedUserQuery

    def predict(self, model: SimilarModel, query: RecommendedUserQuery) -> PredictedResult:
        return super().predict(
            model, Query(items=tuple(query.users), num=query.num,
                         white_list=query.white_list, black_list=query.black_list))


def engine_factory() -> Engine:
    return Engine(
        data_source_class_map=SimilarProductDataSource,
        preparator_class_map=SimilarProductPreparator,
        algorithm_class_map={"als": RecommendedUserAlgorithm},
        serving_class_map=FirstServing,
    )
