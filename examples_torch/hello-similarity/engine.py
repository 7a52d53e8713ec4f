"""A from-scratch DASE engine: entity similarity over word sets.

Port of the JAX package's ``examples/hello-similarity``. Demonstrates
the port's controller API without any template: typed params, reading
aggregated properties from the event store, device compute in torch,
and a custom Query/PredictedResult pair.

Where the JAX example keeps host vectors and a device copy made on the
first predict (dropped from pickles), the port's model holds its
vectors as one tensor on the model's device: it stays there between
queries, and the port's persistence writes a host copy into the model
blob and puts it back on the deploy's device
(``workflow/persistence.load_models``), so no device handle is ever
pickled. The top-k keeps ``lax.top_k``'s tie rule (equal cosines in
ascending row order) through ``ops/topk.topk_lowest_index``: word-set
cosines tie often.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from predictionio_tpu_torch.controller import (
    DataSource,
    Engine,
    FirstServing,
    HostModelAlgorithm,
    IdentityPreparator,
    Params,
)
from predictionio_tpu_torch.ops.topk import topk_lowest_index
from predictionio_tpu_torch.utils.device import ieee_f32


@dataclasses.dataclass(frozen=True)
class Query:
    entity: str = ""
    num: int = 3


@dataclasses.dataclass(frozen=True)
class Neighbor:
    entity: str
    score: float


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    neighbors: tuple = ()


@dataclasses.dataclass(frozen=True)
class DSParams(Params):
    app_name: str = ""
    entity_type: str = "doc"


class WordsDataSource(DataSource):
    params_class = DSParams

    def read_training(self, ctx):
        props = ctx.event_store().aggregate_properties(
            self.params.app_name, self.params.entity_type, required=["words"])
        return {entity_id: tuple(pm.get("words", list))
                for entity_id, pm in sorted(props.items())}


@dataclasses.dataclass(frozen=True)
class AlgoParams(Params):
    pass


@dataclasses.dataclass
class SimilarityModel:
    entities: list
    vectors: torch.Tensor  # (n, vocab) f32, L2-normalised, on the model's device


class CosineAlgorithm(HostModelAlgorithm):
    params_class = AlgoParams
    query_class = Query

    def train(self, ctx, td: dict) -> SimilarityModel:
        vocab = sorted({w for words in td.values() for w in words})
        w_ix = {w: i for i, w in enumerate(vocab)}
        entities = list(td)
        mat = np.zeros((len(entities), max(len(vocab), 1)), np.float32)
        for r, e in enumerate(entities):
            for w in td[e]:
                mat[r, w_ix[w]] = 1.0
        norm = np.linalg.norm(mat, axis=1, keepdims=True)
        mat = mat / np.maximum(norm, 1e-9)
        return SimilarityModel(entities=entities,
                               vectors=torch.from_numpy(mat).to(ctx.device))

    def predict(self, model: SimilarityModel, query: Query) -> PredictedResult:
        if query.entity not in model.entities:
            return PredictedResult()
        k = max(0, min(query.num, len(model.entities) - 1))
        if k == 0:
            return PredictedResult()
        row = model.entities.index(query.entity)
        vecs = model.vectors                      # device-resident between queries
        with ieee_f32():
            sims = vecs @ vecs[row]
        sims[row] = -1.0                          # exclude self
        vals, idxs = topk_lowest_index(sims, k)
        return PredictedResult(neighbors=tuple(
            Neighbor(entity=model.entities[int(i)], score=float(v))
            for v, i in zip(vals.tolist(), idxs.tolist()) if v > -1.0))


def engine_factory() -> Engine:
    return Engine(
        data_source_class_map=WordsDataSource,
        preparator_class_map=IdentityPreparator,
        algorithm_class_map={"cosine": CosineAlgorithm},
        serving_class_map=FirstServing,
    )
