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

Two model kinds serve through the same path: ``"seqrec"`` (the trained
SASRec-family ``models/seqrec.SeqRec``, a ``SeqRecConfig``) and
``"moe_seqrec"`` (``models/moe_seqrec.MoESeqRec``, a Mellum-class MoE
block from a ``MoESeqRecConfig``, served from given weights). The kind
follows the config's class and is saved beside it; a saved model
without one is a ``"seqrec"``.

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
import itertools
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
from predictionio_tpu_torch.models import moe_seqrec, seqrec
from predictionio_tpu_torch.obs.trace import span
from predictionio_tpu_torch.ops.topk import serving_k
from predictionio_tpu_torch.utils.bimap import BiMap
from predictionio_tpu_torch.utils.device import resolve_device

_NEG = np.float32(-1e30)
#: largest power-of-two batch one forward takes
_MAX_BUCKET = 256
#: model kind -> (config class, module class)
KINDS = {"seqrec": (seqrec.SeqRecConfig, seqrec.SeqRec),
         "moe_seqrec": (moe_seqrec.MoESeqRecConfig, moe_seqrec.MoESeqRec)}


def model_kind(cfg: Any) -> str:
    return next(kind for kind, (cls, _) in KINDS.items() if isinstance(cfg, cls))


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
    Serving reads none of them (the model carries its config).
    ``use_mesh`` trains over the context's mesh when it spans more than
    one position (``meshConf`` ``{"axes": {"data": 4, "seq": 2}}``: ring
    attention over "seq", whose size must divide ``max_len``)."""

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
    # the module's state dict: f32 on the host for a SeqRec; in the
    # config's dtype, on the host or the device, for a MoESeqRec
    params: dict
    cfg: seqrec.SeqRecConfig | moe_seqrec.MoESeqRecConfig
    item_index: BiMap       # item id string -> dense index (1-based)
    histories: dict         # user -> [dense item indices] (serving state)
    device: torch.device = dataclasses.field(default_factory=lambda: resolve_device())
    # the module on ``device``, built on first predict; never saved
    module: Any = dataclasses.field(default=None, repr=False, compare=False)
    # ``histories`` packed for serving, built on first predict; never saved
    packed: tuple | None = dataclasses.field(default=None, repr=False, compare=False)
    # per-step losses and seconds of the run that trained it; never saved
    train_run: seqrec.TrainRun | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def as_module(self) -> seqrec.SeqRec | moe_seqrec.MoESeqRec:
        if self.module is None:
            module_class = KINDS[model_kind(self.cfg)][1]
            self.module = module_class.from_state(self.cfg, self.params, self.device)
        return self.module

    def metric_families(self) -> list:
        """What the served module exports at scrape time (the MoE kind's
        device-side counters); nothing before its first predict, or for
        a module with none."""
        fn = getattr(self.module, "metric_families", None)
        return fn() if fn is not None else []

    def packed_histories(self) -> tuple[np.ndarray, dict]:
        """``(ids, spans)``: every user's history end to end in one int32
        array, and each user's ``(start, end)`` in it."""
        if self.packed is None:
            hists = self.histories
            lengths = np.fromiter(map(len, hists.values()), np.int64, len(hists))
            ends = np.cumsum(lengths)
            ids = np.fromiter(itertools.chain.from_iterable(hists.values()), np.int32,
                              int(ends[-1]) if len(ends) else 0)
            self.packed = (ids, dict(zip(hists, zip((ends - lengths).tolist(),
                                                    ends.tolist()))))
        return self.packed

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


def init_engine_model(cfg: seqrec.SeqRecConfig | moe_seqrec.MoESeqRecConfig,
                      item_ids: list[str], histories: Mapping[str, list[str]], *,
                      seed: int = 0, device: str | torch.device | None = None,
                      params: Mapping[str, torch.Tensor] | None = None) -> SeqRecEngineModel:
    """A model of ``cfg``'s kind with the given ``params`` (its state
    dict), else random weights from ``seed``: dense index i+1 for
    ``item_ids[i]``; ``histories`` are given in item ids."""
    if len(item_ids) + 1 != cfg.vocab:
        raise ValueError(f"{len(item_ids)} items need vocab {len(item_ids) + 1}, "
                         f"config has {cfg.vocab}")
    item_index = BiMap({item: i + 1 for i, item in enumerate(item_ids)})
    if params is None:
        init = moe_seqrec.init_params if model_kind(cfg) == "moe_seqrec" else seqrec.init_params
        params = init(cfg, torch.Generator().manual_seed(seed))
    return SeqRecEngineModel(
        params=dict(params),
        cfg=cfg,
        item_index=item_index,
        histories={u: [item_index[i] for i in h] for u, h in histories.items()},
        device=resolve_device(device),
    )


def save_engine_model(model: SeqRecEngineModel, directory: str) -> None:
    """``params.npz`` (f32 arrays by state-dict key; bf16 weights widen
    exactly) + ``model.json`` (model kind, config, item index,
    histories)."""
    os.makedirs(directory, exist_ok=True)
    np.savez(os.path.join(directory, "params.npz"),
             **{k: v.detach().float().cpu().numpy() for k, v in model.params.items()})
    doc = {"kind": model_kind(model.cfg), "cfg": model.cfg.to_json(),
           "itemIndex": model.item_index.to_dict(), "histories": model.histories}
    with open(os.path.join(directory, "model.json"), "w") as f:
        json.dump(doc, f)


def load_engine_model(directory: str, device: str | torch.device | None = None
                      ) -> SeqRecEngineModel:
    with open(os.path.join(directory, "model.json")) as f:
        doc = json.load(f)
    cfg = KINDS[doc.get("kind", "seqrec")][0].from_json(doc["cfg"])
    # a MoESeqRec's weights are held in its dtype from load on
    dtype = cfg.dtype if model_kind(cfg) == "moe_seqrec" else torch.float32
    with np.load(os.path.join(directory, "params.npz")) as arrays:
        params = {k: torch.from_numpy(arrays[k]).to(dtype) for k in arrays.files}
    return SeqRecEngineModel(
        params=params,
        cfg=cfg,
        item_index=BiMap(doc["itemIndex"]),
        histories=doc["histories"],
        device=resolve_device(device),
    )


def _assemble_bucket(model: SeqRecEngineModel, ids: np.ndarray, lengths: np.ndarray,
                     black: np.ndarray, black_counts: np.ndarray
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """One bucket's (B, S) int64 histories, right-padded with PAD, and
    its (B, V) f32 additive logit mask (``_NEG`` at PAD, at each row's
    history ids and at its black-list ids, else 0), built on
    ``model.device`` from one upload. ``ids`` holds the rows' history
    tails end to end (``lengths`` each), ``black`` their black-list ids
    (``black_counts`` each).

    The host computes every scatter index and stages them with the ids
    in one int64 buffer: pinned (a block of torch's caching host
    allocator, per call) and copied asynchronously on CUDA, so nothing
    on the device waits for the host."""
    S, V, device = model.cfg.max_len, model.cfg.vocab, torch.device(model.device)
    B, n, m = len(lengths), len(ids), len(black)
    rows = np.arange(B, dtype=np.int64)
    # [ids | their places in the flattened (B, S) | the flattened (B, V)
    #  places of the rows' history ids, black-list ids and PAD]
    staged = torch.empty(3 * n + m + B, dtype=torch.int64, pin_memory=device.type == "cuda")
    buf = staged.numpy()
    buf[:n] = ids
    np.add(np.arange(n), np.repeat(rows * S - (np.cumsum(lengths) - lengths), lengths),
           out=buf[n : 2 * n])
    np.add(np.repeat(rows * V, lengths), ids, out=buf[2 * n : 3 * n])
    np.add(np.repeat(rows * V, black_counts), black, out=buf[3 * n : 3 * n + m])
    buf[3 * n + m :] = rows * V + seqrec.PAD
    staged = staged.to(device, non_blocking=True)
    history = torch.zeros(B * S, dtype=torch.int64, device=device)
    history.index_copy_(0, staged[n : 2 * n], staged[:n])
    mask = torch.zeros(B * V, dtype=torch.float32, device=device)
    mask.index_fill_(0, staged[2 * n :], float(_NEG))
    return history.view(B, S), mask.view(B, V)


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
        mesh = ctx.mesh_if_parallel if p.use_mesh else None
        if mesh is not None and "seq" in mesh.shape and p.max_len % mesh.axis_size("seq"):
            raise ValueError(
                f"max_len {p.max_len} must be a multiple of the seq mesh "
                f"axis size ({mesh.axis_size('seq')})"
            )
        run = seqrec.train(
            list(dense.values()), cfg,
            epochs=p.epochs, batch_size=p.batch_size, lr=p.lr, seed=p.seed,
            checkpoint_dir=p.checkpoint_dir or None,
            checkpoint_every=p.checkpoint_every,
            device=ctx.device, mesh=mesh,
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

    def predict(self, model: SeqRecEngineModel, query: Query) -> PredictedResult:
        # single-query serving is the B=1 case of the batched path
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(self, model: SeqRecEngineModel, queries):
        """Power-of-two batch buckets (up to 256 queries) through one
        forward each, with a per-query logit mask: PAD, the session's own
        items and the black list are excluded.

        The host gathers ids only: each query's last ``max_len`` history
        ids (a slice of :meth:`SeqRecEngineModel.packed_histories`, or
        its ``items`` mapped to dense ids) and its black list's. A bucket
        crosses to the device in one copy (pinned, asynchronous, on
        CUDA), and its padded histories and mask are built there
        (:func:`_assemble_bucket`), so the host first waits for the
        device when it fetches the answer.

        Stage spans (``obs.trace.span``), in order: ``seqrec.prepare``
        (every query's ids), then for each bucket ``seqrec.stack`` (the
        bucket's upload and assembly), the model step's
        ``seqrec.copy_in``, ``seqrec.forward`` and ``seqrec.topk``,
        ``seqrec.fetch`` (the host waits for the device's answer) and
        ``seqrec.decode``. A traced unbatched query shows them under
        ``predict`` on ``/traces.json``; under a ``torch.profiler`` they
        are annotations on its timeline."""
        S = model.cfg.max_len
        kept, tails, black, counts, out = [], [], [], [], []
        with span("seqrec.prepare"):
            packed, spans = model.packed_histories()
            index = model.item_index
            for i, q in queries:
                if q.items:
                    known = [di for di in map(index.get, q.items) if di is not None]
                    tail = np.asarray(known[-S:], np.int32)
                else:
                    start, end = spans.get(q.user, (0, 0))
                    tail = packed[max(start, end - S) : end]
                if not len(tail):
                    out.append((i, PredictedResult()))
                    continue
                kept.append((i, q))
                tails.append(tail)
                n = len(black)
                black += [di for di in map(index.get, q.black_list) if di is not None]
                counts.append(len(black) - n)
            if not kept:
                return out
            ids = np.concatenate(tails)
            lengths = np.fromiter(map(len, tails), np.int64, len(tails))
            black = np.asarray(black, np.int32)
            counts = np.asarray(counts, np.int64)
            # row r's ids are ids[ends[r]:ends[r + 1]], its black list's
            # black[black_ends[r]:black_ends[r + 1]]
            ends = np.concatenate(([0], np.cumsum(lengths)))
            black_ends = np.concatenate(([0], np.cumsum(counts)))

        # menu-ized top-k width; results trim per query below
        k = serving_k(max(q.num for _, q in kept), model.cfg.vocab - 1)
        module = model.as_module()
        inv = model.item_index.inverse
        pos = 0
        while pos < len(kept):
            remaining = len(kept) - pos
            bucket = 1
            while bucket * 2 <= min(remaining, _MAX_BUCKET):
                bucket *= 2
            lo, hi = pos, pos + bucket
            pos = hi
            with span("seqrec.stack"):
                histories, masks = _assemble_bucket(
                    model, ids[ends[lo] : ends[hi]], lengths[lo:hi],
                    black[black_ends[lo] : black_ends[hi]], counts[lo:hi])
            scores, top = seqrec.predict_topk_batch(module, histories, k, masks,
                                                    real_tokens=int(lengths[lo:hi].sum()))
            with span("seqrec.fetch"):
                scores = scores.cpu().numpy()
                top = top.cpu().numpy()
            with span("seqrec.decode"):
                for (i, q), svals, sids in zip(kept[lo:hi], scores, top):
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
