"""Similarproduct template, add-rateevent variant.

Port of the JAX package's ``examples/similarproduct-add-rateevent``,
itself the reference's add-rateevent variant (reference:
examples/scala-parallel-similarproduct/add-rateevent/): the DataSource
reads "rate" events carrying a ``rating`` property instead of binary
views (DataSource.scala:80-111), a user re-rating the same item keeps
only the LATEST rating (ALSAlgorithm.scala:105-113 reduceByKey on
event time), and training switches from ``ALS.trainImplicit`` to
EXPLICIT ``ALS.train`` on the rating values (ALSAlgorithm.scala:128).
Queries and cosine-similarity serving are unchanged.

Design note: the keep-latest dedup is one host pass (a stable sort by
time, keep each pair's last) before the COO build — no shuffle, no
reduceByKey. Explicit training is the template's
``train_als(implicit=False)``: ``ops/als.als_train`` on the context's
device, the same ALS-WR the recommendation template runs.
"""

from __future__ import annotations

import numpy as np

from predictionio_tpu_torch.controller import Engine, FirstServing
from predictionio_tpu_torch.templates.similarproduct import (
    DataSourceParams,
    SimilarALSAlgorithm,
    SimilarProductDataSource,
    SimilarProductPreparator,
    SimilarTrainingData,
)


class RateEventDataSource(SimilarProductDataSource):
    """Reads user-rate-item events; keeps the latest rating per
    (user, item) pair."""

    params_class = DataSourceParams

    def read_training(self, ctx) -> SimilarTrainingData:
        p = self.params
        users, items, ratings, times = [], [], [], []
        for ev in ctx.event_store().find(p.app_name, entity_type=p.entity_type,
                                         event_names=["rate"],
                                         target_entity_type=p.target_entity_type):
            if ev.target_entity_id is None:
                continue
            rating = ev.properties.get_opt("rating")
            if rating is None:
                continue
            users.append(ev.entity_id)
            items.append(ev.target_entity_id)
            ratings.append(float(rating))
            times.append(ev.event_time.timestamp() if ev.event_time else 0.0)
        # keep-latest per (user, item): stable sort by time, then one
        # pass keeping each pair's last occurrence (the reference's
        # reduceByKey-on-t, ALSAlgorithm.scala:105-113, as a host pass)
        latest: dict[tuple[str, str], int] = {}
        for j in np.argsort(np.asarray(times), kind="stable"):
            latest[(users[j], items[j])] = int(j)
        keep = sorted(latest.values())
        categories: dict[str, tuple] = {}
        props = ctx.event_store().aggregate_properties(p.app_name, p.item_entity_type)
        for item_id, pm in props.items():
            cats = pm.get_opt("categories")
            if cats:
                categories[item_id] = tuple(cats)
        return SimilarTrainingData(
            users=np.asarray([users[j] for j in keep], dtype=object),
            items=np.asarray([items[j] for j in keep], dtype=object),
            ratings=np.asarray([ratings[j] for j in keep], dtype=np.float32),
            categories=categories)


class RateEventALSAlgorithm(SimilarALSAlgorithm):
    """Explicit ALS-WR on the rating values (the reference variant's
    ALS.train swap, ALSAlgorithm.scala:128); serving unchanged."""

    implicit_prefs = False


def engine_factory() -> Engine:
    return Engine(
        data_source_class_map=RateEventDataSource,
        preparator_class_map=SimilarProductPreparator,
        algorithm_class_map={"als": RateEventALSAlgorithm},
        serving_class_map=FirstServing,
    )
