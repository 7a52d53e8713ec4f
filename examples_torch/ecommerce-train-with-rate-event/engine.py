"""E-commerce template, train-with-rate-event variant.

Port of the JAX package's ``examples/ecommerce-train-with-rate-event``,
itself the reference's train-with-rate-event variant (reference:
examples/scala-parallel-ecommercerecommendation/train-with-rate-event/
src/main/scala/{DataSource,ALSAlgorithm}.scala): instead of the base
template's unit-confidence view/buy events, training reads explicit
``rate`` events carrying a ``rating`` property (DataSource.scala:80-105)
— the LATEST rating per (user, item) wins when a user re-rates
(ALSAlgorithm.scala:115-116 reduceByKey on event time) — and the
rating VALUE becomes the per-interaction implicit-confidence weight
fed to ``ALS.trainImplicit`` (ALSAlgorithm.scala:97-111).

Only the DataSource changes (host code); the port's ECommAlgorithm
already trains implicit ALS on the context's device from the prepared
(user, item, weight) triples, and all the template's serving machinery
(business rules, unavailable items, unknown-user fallback) carries over
untouched.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from predictionio_tpu_torch.controller import Engine, FirstServing
from predictionio_tpu_torch.templates.ecommerce import (
    DataSourceParams,
    ECommAlgorithm,
    ECommDataSource,
    ECommPreparator,
    ECommTrainingData,
)


@dataclasses.dataclass(frozen=True)
class RateDataSourceParams(DataSourceParams):
    rate_events: tuple = ("rate",)
    rating_property: str = "rating"


class RateEventDataSource(ECommDataSource):
    """Reads rate events; latest rating per (user, item) wins; the
    rating value is the interaction's confidence weight."""

    params_class = RateDataSourceParams

    def read_training(self, ctx) -> ECommTrainingData:
        p = self.params
        store = ctx.event_store()
        latest: dict[tuple[str, str], tuple] = {}
        for ev in store.find(p.app_name, entity_type=p.entity_type,
                             event_names=list(p.rate_events),
                             target_entity_type=p.target_entity_type):
            if ev.target_entity_id is None:
                continue
            rating = ev.properties.get_opt(p.rating_property)
            if rating is None:
                continue
            key = (ev.entity_id, ev.target_entity_id)
            prev = latest.get(key)
            if prev is None or ev.event_time > prev[0]:
                latest[key] = (ev.event_time, float(rating))
        categories: dict[str, tuple] = {}
        for item_id, pm in store.aggregate_properties(p.app_name,
                                                      p.item_entity_type).items():
            cats = pm.get_opt("categories")
            if cats:
                categories[item_id] = tuple(cats)
        return ECommTrainingData(
            users=np.asarray([u for u, _ in latest], dtype=object),
            items=np.asarray([i for _, i in latest], dtype=object),
            weights=np.asarray([r for _, r in latest.values()], dtype=np.float32),
            categories=categories)


def engine_factory() -> Engine:
    return Engine(
        data_source_class_map=RateEventDataSource,
        preparator_class_map=ECommPreparator,
        algorithm_class_map={"ecomm": ECommAlgorithm},
        serving_class_map=FirstServing,
    )
