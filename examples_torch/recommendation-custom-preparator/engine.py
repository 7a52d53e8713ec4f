"""Recommendation template + custom Preparator: train-time item exclusion.

Port of the JAX package's ``examples/recommendation-custom-preparator``,
itself the reference's custom-preparator variant (reference:
examples/scala-parallel-recommendation/custom-prepartor/src/main/scala/
Preparator.scala): a Preparator with its own Params pointing at a
no-train-items file; listed items are dropped from the ratings BEFORE
training, so the model never learns factors for them (vs the
custom-serving variant, which hides items at serve time but still
trains on them). Everything else (DataSource, ALS algorithm on the
context's device, Serving) is reused straight from the port's
recommendation template; only the Preparator is custom, and it filters
host arrays.
"""

from __future__ import annotations

import dataclasses
import os

from predictionio_tpu_torch.controller import Engine, FirstServing, Params
from predictionio_tpu_torch.templates.recommendation import (
    ALSAlgorithm,
    ALSPreparator,
    RecommendationDataSource,
    TrainingData,
)


@dataclasses.dataclass(frozen=True)
class CustomPreparatorParams(Params):
    """filepath: one item id per line to exclude from training
    (CustomPreparatorParams in the reference's Preparator.scala)."""

    filepath: str = "no_train_items.txt"


class ExcludeItemsPreparator(ALSPreparator):
    """Filters no-train items out of the raw triples, then applies the
    standard id-indexing preparation."""

    params_class = CustomPreparatorParams

    def prepare(self, ctx, td: TrainingData):
        no_train: set[str] = set()
        if os.path.exists(self.params.filepath):
            with open(self.params.filepath) as f:
                no_train = {line.strip() for line in f if line.strip()}
        if no_train:
            keep = [i for i, item in enumerate(td.items) if item not in no_train]
            td = TrainingData(users=td.users[keep], items=td.items[keep],
                              ratings=td.ratings[keep])
        return super().prepare(ctx, td)


def engine_factory() -> Engine:
    return Engine(
        data_source_class_map=RecommendationDataSource,
        preparator_class_map=ExcludeItemsPreparator,
        algorithm_class_map={"als": ALSAlgorithm},
        serving_class_map=FirstServing,
    )
