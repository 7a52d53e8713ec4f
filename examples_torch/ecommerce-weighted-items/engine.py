"""E-commerce template, weighted-items variant.

Port of the JAX package's ``examples/ecommerce-weighted-items``, itself
the reference's weighted-items variant (reference:
examples/scala-parallel-ecommercerecommendation/weighted-items/
src/main/scala/ALSAlgorithm.scala:70-74, 234-295): operators publish
weight groups as a ``$set`` event on the constraint entity
``weightedItems`` —

    {"weights": [{"items": ["i1", "i2"], "weight": 2.0},
                 {"items": ["i9"],       "weight": 0.5}]}

— and every query re-reads the LATEST groups and multiplies each item's
score by its weight (default 1.0). Promoted items (> 1.0) surface more
often, demoted ones (< 1.0) less, all live: no retrain, no redeploy.

Design note: for known users the reference multiplies scores
item-by-item inside its ranking loop; here, as in the JAX package, the
weights fold into the item-factor table (``score = u . (w * v) =
w * (u . v)`` for w >= 0), so the masked top-k runs unchanged on the
factors' device — the weighting costs one (I, K) elementwise multiply
there, cached per (weights version, model). The weights vector is built
on the host and moved to the factors' device once per version. The
unknown-user fallback ranks by cosine similarity — which normalizes a
table scaling away — so that path re-weights the similarity scores
over an expanded candidate pool on the host instead (both paths
weighted, like the reference's predictKnownUser/predictSimilar).
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import torch

from predictionio_tpu_torch.controller import Engine, FirstServing
from predictionio_tpu_torch.templates.ecommerce import (
    ECommAlgorithm,
    ECommAlgorithmParams,
    ECommDataSource,
    ECommModel,
    ECommPreparator,
    ItemScore,
    PredictedResult,
    Query,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class WeightedParams(ECommAlgorithmParams):
    weight_constraint_id: str = "weightedItems"


class WeightedECommAlgorithm(ECommAlgorithm):
    """ECommAlgorithm + live per-item score weights."""

    params_class = WeightedParams

    def __init__(self, params=None):
        super().__init__(params)
        # (weights-event version, base ALS model, weighted model)
        self._weight_cache: tuple[str | None, object, object] | None = None

    def _weight_groups(self):
        """Latest $set on (constraint, weightedItems) -> list of
        {items, weight} groups; [] when unset (ALSAlgorithm.scala:234-251
        in the variant, same live-read pattern as unavailableItems)."""
        p = self.params
        if self._ctx is None or not p.app_name:
            return None, []
        try:
            events = list(self._ctx.event_store().find_by_entity(
                p.app_name, p.unavailable_constraint_entity, p.weight_constraint_id,
                event_names=["$set"], limit=1, latest=True))
        except Exception:
            return None, []
        if not events:
            return None, []
        ev = events[0]
        groups = ev.properties.get_opt("weights") or []
        return ev.event_id, groups

    def _weights_vector(self, model: ECommModel):
        """(version, host f32 weights of catalog length or None)."""
        version, groups = self._weight_groups()
        if not groups:
            return version, None
        w = np.ones(len(model.als.item_ids), dtype=np.float32)
        for group in groups:
            try:
                weight = float(group.get("weight", 1.0))
            except (TypeError, ValueError, AttributeError):
                # non-dict entries land here too (AttributeError on .get)
                logger.warning("skipping malformed weight group: %r", group)
                continue
            if not (math.isfinite(weight) and weight >= 0.0):
                # one malformed operator event must not poison the
                # serving path — the reference variant applies weights
                # unvalidated; we skip the bad group (negative, NaN or
                # inf weights would corrupt every score) and keep serving
                logger.warning("skipping invalid item weight group: %r", group)
                continue
            for item_id in group.get("items", []):
                ix = model.als.item_ids.get(item_id)
                if ix is not None:
                    w[ix] = weight
        return version, w

    def _weighted_model(self, model: ECommModel) -> ECommModel:
        """Item factors scaled by the current weights, cached per
        (weights-event version, base model) — the base model changes
        across eval folds and /reload hot-swaps, so the version alone
        is not a sound key."""
        version, w = self._weights_vector(model)
        if w is None:
            return model
        # hold the base ALS model itself in the cache entry and compare
        # by identity to that held object — a raw id() key can alias a
        # new model allocated at a freed model's address after /reload
        if (self._weight_cache is not None and self._weight_cache[0] == version
                and self._weight_cache[1] is model.als):
            return self._weight_cache[2]
        als = model.als
        w_dev = torch.as_tensor(w, dtype=als.item_factors.dtype, device=als.device)
        # dataclasses.replace copies every other field, as the JAX
        # package's replace does: the device all-ones allow vector (the
        # same catalog), the ANN index built on the UNWEIGHTED factors
        # (none below 1,024 items, so none at example scale) and the
        # online overlay
        weighted = ECommModel(
            als=dataclasses.replace(als, item_factors=als.item_factors * w_dev[:, None]),
            categories=model.categories)
        self._weight_cache = (version, model.als, weighted)
        return weighted

    def predict(self, model: ECommModel, query: Query) -> PredictedResult:
        if query.user in model.als.user_ids:
            # known user: dot-product ranking, where the weights fold
            # exactly into the factor table (u . (w v) = w (u . v))
            return super().predict(self._weighted_model(model), query)
        # unknown user: the fallback ranks by COSINE similarity, which
        # normalizes a factor-table scaling away — apply the weights to
        # the similarity scores instead (the reference variant
        # multiplies final scores on both paths, ALSAlgorithm.scala:
        # 294-295, 400-401), over an expanded candidate pool so
        # promoted items outside the unweighted top-num can surface
        version, w = self._weights_vector(model)
        recent = self._recent_items(query.user)
        if not recent or w is None:
            return super().predict(model, query)
        allow = self._allow_vector(model, query)
        pool = model.als.similar(recent, min(query.num * 8, model.als.item_factors.shape[0]),
                                 allow=allow)
        rescored = sorted(((item, score * float(w[model.als.item_ids[item]]))
                           for item, score in pool), key=lambda kv: -kv[1])[: query.num]
        return PredictedResult(item_scores=tuple(ItemScore(item=i, score=s)
                                                 for i, s in rescored))


def engine_factory() -> Engine:
    return Engine(
        data_source_class_map=ECommDataSource,
        preparator_class_map=ECommPreparator,
        algorithm_class_map={"ecomm": WeightedECommAlgorithm},
        serving_class_map=FirstServing,
    )
