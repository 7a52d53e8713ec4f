"""Session-based sequential recommendation engine template: the port of
the JAX package's ``templates/sessionrec.py``: training, serving and
evaluation.

The data source reads each user's events from the event store into a
time-ordered item sequence; the algorithm indexes the items (dense ids
from 1 in string order), trains the transformer of ``models/seqrec.py``
on the context's device and keeps each user's history as serving state.
Query {"user": ..., "num": N} (or {"items": [recent ids], "num": N})
answers with the N most likely next items, never one of the session's
own items or the query's ``blackList``. A model is saved as
``params.npz`` + ``model.json`` (:func:`save_engine_model`); a trained
one at the run's ``checkpoint_location``, behind a
``PersistentModelManifest``. Besides training, a model comes from
:func:`init_engine_model` (random weights from a seeded generator) or
from a JAX-trained model's arrays (:meth:`SeqRecEngineModel.from_jax`).
Evaluation holds out each user's last item (``read_eval``, leave-one-out
over ``eval_k`` folds) and scores HitRate@K: ``run_evaluation(
SessionRecEvaluation(), DefaultParamsList(app_name=...))``, each fold
trained on the context's device and predicted through ``batch_predict``.

Usage (engine.json):
    {"engineFactory":
       "predictionio_tpu_torch.templates.sessionrec.engine_factory",
     "datasource": {"params": {"app_name": "MyApp"}},
     "algorithms": [{"name": "seqrec",
                     "params": {"d_model": 64, "n_layers": 2,
                                "max_len": 64, "epochs": 20}}]}
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping

import numpy as np
import torch

from predictionio_tpu_torch.controller import (
    DataSource,
    Engine,
    EngineParams,
    EngineParamsGenerator,
    Evaluation,
    FirstServing,
    HostModelAlgorithm,
    IdentityPreparator,
    MetricEvaluator,
    OptionAverageMetric,
    Params,
    PersistentModelManifest,
    SanityCheck,
)
from predictionio_tpu_torch.controller.persistent_model import checkpoint_location
from predictionio_tpu_torch.models import seqrec
from predictionio_tpu_torch.ops.topk import serving_k
from predictionio_tpu_torch.utils.bimap import BiMap
from predictionio_tpu_torch.utils.device import resolve_device

_NEG = np.float32(-1e30)
#: largest power-of-two batch one forward takes
_MAX_BUCKET = 256


@dataclasses.dataclass(frozen=True)
class Query:
    user: str = ""
    items: tuple = ()        # explicit recent-item history (overrides user)
    num: int = 10
    black_list: tuple = ()


@dataclasses.dataclass(frozen=True)
class ItemScore:
    item: str
    score: float


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    item_scores: tuple = ()


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    event_names: tuple = ("view", "buy")
    entity_type: str = "user"
    target_entity_type: str = "item"
    min_sequence_len: int = 2
    eval_k: int = 0


@dataclasses.dataclass(frozen=True)
class AlgorithmParams(Params):
    """The JAX template's parameters, so one engine.json binds to both.
    Serving reads none of them (the model carries its config);
    ``use_mesh`` has no effect: training over a sequence mesh (ring
    attention) is ROADMAP.md queue 1 item 29."""

    d_model: int = 64
    n_heads: int = 2
    n_layers: int = 2
    max_len: int = 64
    epochs: int = 20
    batch_size: int = 64
    lr: float = 1e-3
    seed: int = 0
    use_mesh: bool = True
    remat: bool = False
    checkpoint_dir: str = ""
    checkpoint_every: int = 0


@dataclasses.dataclass
class TrainingData(SanityCheck):
    sequences: dict  # user id -> [item ids, time-ordered]

    def sanity_check(self) -> None:
        if not self.sequences:
            raise ValueError("no user event sequences found")


class SessionDataSource(DataSource):
    """Reads per-user time-ordered item sequences: each user's events of
    ``event_names`` with a target item, stably sorted by event time
    (events of one time keep the store's (time, id) order), users with
    fewer than ``min_sequence_len`` items left out."""

    params_class = DataSourceParams

    def read_training(self, ctx: Any) -> TrainingData:
        p = self.params
        events = ctx.event_store().find(
            p.app_name,
            entity_type=p.entity_type,
            event_names=list(p.event_names),
            target_entity_type=p.target_entity_type,
        )
        per_user: dict[str, list] = {}
        for ev in events:
            if not ev.target_entity_id:
                continue
            per_user.setdefault(ev.entity_id, []).append((ev.event_time, ev.target_entity_id))
        sequences = {
            user: [item for _, item in sorted(pairs, key=lambda t: t[0])]
            for user, pairs in per_user.items()
        }
        return TrainingData(sequences={
            u: seq for u, seq in sequences.items() if len(seq) >= p.min_sequence_len})

    def read_eval(self, ctx: Any) -> list:
        """Leave-one-out over ``max(eval_k, 1)`` folds: user i of the
        sorted users is held out in fold ``i % k`` when its sequence is
        longer than ``min_sequence_len``; a held-out user trains on all
        but its last item, which is the query's answer."""
        p = self.params
        full = self.read_training(ctx).sequences
        users = sorted(full)
        k = max(p.eval_k, 1)
        folds = []
        for fold in range(k):
            train_seqs, qa = {}, []
            for i, u in enumerate(users):
                seq = full[u]
                if i % k == fold and len(seq) > p.min_sequence_len:
                    train_seqs[u] = seq[:-1]
                    qa.append((Query(user=u), seq[-1]))
                else:
                    train_seqs[u] = seq
            folds.append((TrainingData(sequences=train_seqs), {"fold": fold}, qa))
        return folds


@dataclasses.dataclass
class SeqRecEngineModel:
    params: dict            # f32 state dict on the host (models/seqrec.py keys)
    cfg: seqrec.SeqRecConfig
    item_index: BiMap       # item id string -> dense index (1-based)
    histories: dict         # user -> [dense item indices] (serving state)
    device: torch.device = dataclasses.field(default_factory=lambda: resolve_device())
    # the module on ``device``, built on first predict; never saved
    module: Any = dataclasses.field(default=None, repr=False, compare=False)
    # per-step losses and seconds of the run that trained it; never saved
    train_run: seqrec.TrainRun | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def as_module(self) -> seqrec.SeqRec:
        if self.module is None:
            self.module = seqrec.SeqRec.from_state(self.cfg, self.params, self.device)
        return self.module

    @staticmethod
    def from_jax(params_tree: Mapping, cfg_fields: Mapping[str, Any],
                 item_index: Mapping[str, int], histories: Mapping[str, list],
                 device: str | torch.device | None = None) -> "SeqRecEngineModel":
        """From a JAX-trained model's arrays: its parameter pytree (numpy),
        its config's fields, its item index and histories."""
        return SeqRecEngineModel(
            params=seqrec.params_from_jax(params_tree),
            cfg=seqrec.SeqRecConfig.from_json(cfg_fields),
            item_index=BiMap(dict(item_index)),
            histories={u: [int(i) for i in h] for u, h in histories.items()},
            device=resolve_device(device),
        )


def init_engine_model(cfg: seqrec.SeqRecConfig, item_ids: list[str],
                      histories: Mapping[str, list[str]], *, seed: int = 0,
                      device: str | torch.device | None = None) -> SeqRecEngineModel:
    """A model with random weights from ``seed``: dense index i+1 for
    ``item_ids[i]``; ``histories`` are given in item ids."""
    if len(item_ids) + 1 != cfg.vocab:
        raise ValueError(f"{len(item_ids)} items need vocab {len(item_ids) + 1}, "
                         f"config has {cfg.vocab}")
    item_index = BiMap({item: i + 1 for i, item in enumerate(item_ids)})
    gen = torch.Generator().manual_seed(seed)
    return SeqRecEngineModel(
        params=seqrec.init_params(cfg, gen),
        cfg=cfg,
        item_index=item_index,
        histories={u: [item_index[i] for i in h] for u, h in histories.items()},
        device=resolve_device(device),
    )


def save_engine_model(model: SeqRecEngineModel, directory: str) -> None:
    """``params.npz`` (f32 arrays by state-dict key) + ``model.json``
    (config, item index, histories)."""
    os.makedirs(directory, exist_ok=True)
    np.savez(os.path.join(directory, "params.npz"),
             **{k: v.detach().cpu().numpy() for k, v in model.params.items()})
    doc = {"cfg": model.cfg.to_json(), "itemIndex": model.item_index.to_dict(),
           "histories": model.histories}
    with open(os.path.join(directory, "model.json"), "w") as f:
        json.dump(doc, f)


def load_engine_model(directory: str, device: str | torch.device | None = None
                      ) -> SeqRecEngineModel:
    with open(os.path.join(directory, "model.json")) as f:
        doc = json.load(f)
    with np.load(os.path.join(directory, "params.npz")) as arrays:
        params = {k: torch.from_numpy(arrays[k]) for k in arrays.files}
    return SeqRecEngineModel(
        params=params,
        cfg=seqrec.SeqRecConfig.from_json(doc["cfg"]),
        item_index=BiMap(doc["itemIndex"]),
        histories=doc["histories"],
        device=resolve_device(device),
    )


class SeqRecAlgorithm(HostModelAlgorithm):
    """Trains the causal transformer on the context's device; serves its
    top-k next items."""

    params_class = AlgorithmParams
    query_class = Query

    def train(self, ctx: Any, pd: TrainingData) -> SeqRecEngineModel:
        p = self.params
        items = sorted({i for seq in pd.sequences.values() for i in seq})
        # dense ids start at 1: index 0 is the PAD token
        item_index = BiMap({item: i + 1 for i, item in enumerate(items)})
        dense = {u: [item_index[i] for i in seq] for u, seq in pd.sequences.items()}
        cfg = seqrec.SeqRecConfig(
            vocab=len(items) + 1,
            max_len=p.max_len,
            d_model=p.d_model,
            n_heads=p.n_heads,
            n_layers=p.n_layers,
            remat=p.remat,
        )
        run = seqrec.train(
            list(dense.values()), cfg,
            epochs=p.epochs, batch_size=p.batch_size, lr=p.lr, seed=p.seed,
            checkpoint_dir=p.checkpoint_dir or None,
            checkpoint_every=p.checkpoint_every,
            device=ctx.device,
        )
        return SeqRecEngineModel(params=run.params, cfg=cfg, item_index=item_index,
                                 histories=dense, device=ctx.device, train_run=run)

    def make_persistent_model(self, ctx: Any, model: SeqRecEngineModel
                              ) -> PersistentModelManifest:
        """Saves the model as :func:`save_engine_model` writes it, at the
        run's ``checkpoint_location``, and records a manifest there."""
        location = checkpoint_location(ctx, "seqrec")
        save_engine_model(model, location)
        return PersistentModelManifest(
            class_name=f"{type(self).__module__}.{type(self).__qualname__}", location=location)

    def load_model(self, ctx: Any, manifest: PersistentModelManifest) -> SeqRecEngineModel:
        return load_engine_model(manifest.location, ctx.device)

    def _history_for(self, model: SeqRecEngineModel, query: Query):
        if query.items:
            return [
                model.item_index.get(i)
                for i in query.items
                if model.item_index.get(i) is not None
            ]
        return model.histories.get(query.user, [])

    def predict(self, model: SeqRecEngineModel, query: Query) -> PredictedResult:
        # single-query serving is the B=1 case of the batched path
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(self, model: SeqRecEngineModel, queries):
        """Power-of-two batch buckets (up to 256 queries) through one
        forward each, with a per-query logit mask: PAD, the session's own
        items and the black list are excluded."""
        S = model.cfg.max_len
        base_mask = np.zeros((model.cfg.vocab,), np.float32)
        base_mask[seqrec.PAD] = _NEG
        prepared, out = [], []
        for i, q in queries:
            history = self._history_for(model, q)
            if not history:
                out.append((i, PredictedResult()))
                continue
            tail = history[-S:]
            hist = np.zeros((S,), np.int64)
            hist[: len(tail)] = tail
            mask = base_mask.copy()
            mask[np.asarray(tail, np.int64)] = _NEG   # don't repeat the session
            for item in q.black_list:
                di = model.item_index.get(item)
                if di is not None:
                    mask[di] = _NEG
            prepared.append((i, q, hist, mask))
        if not prepared:
            return out

        # menu-ized top-k width; results trim per query below
        k = serving_k(max(q.num for _, q, _, _ in prepared), model.cfg.vocab - 1)
        module = model.as_module()
        inv = model.item_index.inverse
        pos = 0
        while pos < len(prepared):
            remaining = len(prepared) - pos
            bucket = 1
            while bucket * 2 <= min(remaining, _MAX_BUCKET):
                bucket *= 2
            chunk = prepared[pos : pos + bucket]
            pos += bucket
            scores, ids = seqrec.predict_topk_batch(
                module,
                torch.from_numpy(np.stack([h for _, _, h, _ in chunk])),
                k,
                torch.from_numpy(np.stack([m for _, _, _, m in chunk])),
            )
            for (i, q, _, _), svals, sids in zip(
                    chunk, scores.cpu().numpy(), ids.cpu().numpy()):
                items = []
                for v, ix in zip(svals[: q.num], sids[: q.num]):
                    if v <= _NEG / 2:
                        continue
                    item = inv.get(int(ix))
                    if item is not None:
                        items.append(ItemScore(item=item, score=float(v)))
                out.append((i, PredictedResult(item_scores=tuple(items))))
        return out


def engine_factory() -> Engine:
    return Engine(
        data_source_class_map=SessionDataSource,
        preparator_class_map=IdentityPreparator,
        algorithm_class_map={"seqrec": SeqRecAlgorithm},
        serving_class_map=FirstServing,
    )


class HitRateAtK(OptionAverageMetric):
    """1.0 when the held-out next item is among the top k, else 0.0."""

    def __init__(self, k: int = 10):
        self.k = k

    @property
    def header(self) -> str:
        return f"HitRate@{self.k}"

    def calculate_qpa(self, q: Query, p: PredictedResult, a: str) -> float:
        # the held-out item always exists, so an empty prediction is a
        # miss (0.0), never a skip: None would inflate the average
        return 1.0 if a in [s.item for s in p.item_scores[: self.k]] else 0.0


class SessionRecEvaluation(Evaluation):
    """HitRate@k over the leave-one-out folds of ``read_eval``."""

    def __init__(self, k: int = 10, output_path: str | None = "best.json"):
        super().__init__()
        self.engine_evaluator = (
            engine_factory(),
            MetricEvaluator(HitRateAtK(k=k), output_path=output_path),
        )


class DefaultParamsList(EngineParamsGenerator):
    """The JAX template's grid: d_model {32, 64} × n_layers {1, 2}."""

    def __init__(self, app_name: str = "SessApp", eval_k: int = 2):
        super().__init__([
            EngineParams.of(
                data_source=DataSourceParams(app_name=app_name, eval_k=eval_k),
                algorithms=[(
                    "seqrec",
                    AlgorithmParams(d_model=d, n_layers=layers, max_len=32,
                                    epochs=15, batch_size=32, lr=3e-3),
                )],
            )
            for d in (32, 64)
            for layers in (1, 2)
        ])
