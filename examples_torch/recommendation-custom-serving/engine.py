"""Recommendation template + custom Serving: serve-time item blacklist.

Port of the JAX package's ``examples/recommendation-custom-serving``,
itself the reference's custom-serving variant (reference:
examples/scala-parallel-recommendation/custom-serving/src/main/scala/
Serving.scala): a Serving component with its own Params pointing at a
disabled-products file, re-read on EVERY query so operators can disable
items live — no retrain, no redeploy, just edit the file. Everything
else (DataSource, Preparator, ALS algorithm on the context's device) is
reused straight from the port's recommendation template; only the
Serving class is custom, and it runs on the host.
"""

from __future__ import annotations

import dataclasses
import os

from predictionio_tpu_torch.controller import Engine, Params, Serving
from predictionio_tpu_torch.templates.recommendation import (
    ALSAlgorithm,
    ALSPreparator,
    PredictedResult,
    Query,
    RecommendationDataSource,
)


@dataclasses.dataclass(frozen=True)
class ServingParams(Params):
    """filepath: one disabled item id per line (ServingParams in the
    reference's custom-serving Serving.scala)."""

    filepath: str = "disabled.txt"


class DisabledItemsServing(Serving):
    """Drops disabled items from the head prediction at serve time."""

    params_class = ServingParams

    def _disabled(self) -> set[str]:
        # re-read per query, like the reference's Source.fromFile in
        # serve(): the file is the live control surface
        if not os.path.exists(self.params.filepath):
            return set()
        with open(self.params.filepath) as f:
            return {line.strip() for line in f if line.strip()}

    def serve(self, query: Query, predictions) -> PredictedResult:
        disabled = self._disabled()
        head = predictions[0]
        return PredictedResult(
            item_scores=tuple(s for s in head.item_scores if s.item not in disabled))


def engine_factory() -> Engine:
    return Engine(
        data_source_class_map=RecommendationDataSource,
        preparator_class_map=ALSPreparator,
        algorithm_class_map={"als": ALSAlgorithm},
        serving_class_map=DisabledItemsServing,
    )
