"""The sessionrec serve batch, assembled on the model's device from ids,
against the per-query host assembly it replaced.

``SeqRecAlgorithm.batch_predict`` gathers each query's history ids (a
slice of the model's packed histories, or its ``items``) and black-list
ids, uploads them once a bucket and builds the padded (B, S) histories
and the (B, V) logit mask on the device. ``_reference_batch_predict``
below is the per-query loop that built both on the host (a padded int64
row and a copied 50,000-wide f32 mask per query, ``np.stack`` a
bucket). The tensors handed to ``seqrec.predict_topk_batch`` must be
exactly the reference's, and so must every answer, item for item and
score for score:

- over mixed lengths (histories longer than ``max_len``), repeated ids,
  ``Query.items`` sessions, black lists holding unknown ids, and users
  with empty or missing histories, at batch sizes 1, 3, 64 and 300
  (300 crosses ``_MAX_BUCKET``);
- the packed copy of the histories is built once per model and never
  saved: ``model.json`` is byte-identical with and without a serve, and
  a reloaded model answers identically;
- on the card (``cuda``; skips without one, imports no JAX:
  ``python -m pytest tests/test_torch_sessionrec_batch_assembly.py
  --noconftest``), the tensors handed to ``predict_topk_batch`` are
  already on ``model.device``.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.models import seqrec
from predictionio_tpu_torch.ops.topk import serving_k
from predictionio_tpu_torch.templates import sessionrec
from predictionio_tpu_torch.templates.sessionrec import (
    _MAX_BUCKET,
    _NEG,
    ItemScore,
    PredictedResult,
    Query,
)

CFG = seqrec.SeqRecConfig(vocab=61, max_len=16, d_model=32, n_heads=2, n_layers=1)
ITEMS = [f"i{n}" for n in range(1, CFG.vocab)]
UNKNOWN = ("nope", "i999", "")


def _histories() -> dict[str, list[str]]:
    """Users of every length from 0 to 40 (``max_len`` is 16), users who
    repeat items, and one user with an empty history."""
    rng = np.random.default_rng(7)
    out = {f"u{n}": [ITEMS[j] for j in rng.integers(0, len(ITEMS), n)] for n in range(41)}
    for r in range(8):
        base = [ITEMS[j] for j in rng.integers(0, len(ITEMS), 3)]
        out[f"rep{r}"] = [base[j] for j in rng.integers(0, 3, 5 + 4 * r)]
    out["empty"] = []
    return out


HISTORIES = _histories()


def _model(device="cpu") -> sessionrec.SeqRecEngineModel:
    return sessionrec.init_engine_model(CFG, ITEMS, HISTORIES, seed=5, device=device)


def _reference_batch_predict(model: sessionrec.SeqRecEngineModel, queries):
    """The per-query host assembly that the device assembly replaced:
    each query's padded int64 history and its own copy of the f32 mask,
    ``np.stack``-ed per bucket and handed to ``predict_topk_batch``."""
    S = model.cfg.max_len
    prepared, out = [], []
    base_mask = np.zeros((model.cfg.vocab,), np.float32)
    base_mask[seqrec.PAD] = _NEG
    for i, q in queries:
        if q.items:
            history = [model.item_index.get(it) for it in q.items
                       if model.item_index.get(it) is not None]
        else:
            history = model.histories.get(q.user, [])
        if not history:
            out.append((i, PredictedResult()))
            continue
        tail = history[-S:]
        hist = np.zeros((S,), np.int64)
        hist[: len(tail)] = tail
        mask = base_mask.copy()
        mask[np.asarray(tail, np.int64)] = _NEG
        for item in q.black_list:
            di = model.item_index.get(item)
            if di is not None:
                mask[di] = _NEG
        prepared.append((i, q, hist, mask))
    if not prepared:
        return out
    k = serving_k(max(q.num for _, q, _, _ in prepared), model.cfg.vocab - 1)
    module = model.as_module()
    inv = model.item_index.inverse
    pos = 0
    while pos < len(prepared):
        bucket = 1
        while bucket * 2 <= min(len(prepared) - pos, _MAX_BUCKET):
            bucket *= 2
        chunk = prepared[pos : pos + bucket]
        pos += bucket
        histories = torch.from_numpy(np.stack([h for _, _, h, _ in chunk]))
        masks = torch.from_numpy(np.stack([m for _, _, _, m in chunk]))
        scores, ids = seqrec.predict_topk_batch(module, histories, k, masks)
        for (i, q, _, _), svals, sids in zip(chunk, scores.cpu().numpy(), ids.cpu().numpy()):
            items = []
            for v, ix in zip(svals[: q.num], sids[: q.num]):
                if v <= _NEG / 2:
                    continue
                item = inv.get(int(ix))
                if item is not None:
                    items.append(ItemScore(item=item, score=float(v)))
            out.append((i, PredictedResult(item_scores=tuple(items))))
    return out


@contextlib.contextmanager
def _captured():
    """Every (history, masks) pair handed to ``predict_topk_batch``."""
    calls = []
    original = seqrec.predict_topk_batch

    def capture(module, history, k, masks, **kw):
        calls.append((history.clone(), masks.clone()))
        return original(module, history, k, masks, **kw)

    seqrec.predict_topk_batch = capture
    try:
        yield calls
    finally:
        seqrec.predict_topk_batch = original


def _queries(kind: str, n: int, seed: int) -> list[tuple[int, Query]]:
    rng = np.random.default_rng(seed)
    users = [u for u in HISTORIES if u.startswith("u") and HISTORIES[u]]
    out = []
    for i in range(n):
        num = int(rng.integers(1, 13))
        pick = kind if kind != "everything" else ("mixed_lengths", "repeated_ids", "items",
                                                  "unknown_black_list",
                                                  "empty_or_missing")[i % 5]
        if pick == "mixed_lengths":
            q = Query(user=users[rng.integers(len(users))], num=num)
        elif pick == "repeated_ids":
            q = Query(user=f"rep{rng.integers(8)}", num=num)
        elif pick == "items":
            length = int(rng.integers(0, 30))
            pool = ITEMS + list(UNKNOWN)
            q = Query(items=tuple(pool[j] for j in rng.integers(0, len(pool), length)),
                      num=num)
        elif pick == "unknown_black_list":
            black = tuple(ITEMS[j] for j in rng.integers(0, len(ITEMS), rng.integers(0, 6)))
            q = Query(user=users[rng.integers(len(users))], num=num,
                      black_list=black + UNKNOWN[: int(rng.integers(1, 4))])
        else:
            q = Query(user=("empty", "ghost", users[rng.integers(len(users))])[i % 3], num=num)
        out.append((i, q))
    return out


KINDS = ["mixed_lengths", "repeated_ids", "items", "unknown_black_list",
         "empty_or_missing", "everything"]


@pytest.mark.parametrize("batch", [1, 3, 64, 300])
@pytest.mark.parametrize("kind", KINDS)
def test_device_assembly_equals_the_host_assembly(kind, batch):
    model = _model()
    queries = _queries(kind, batch, seed=KINDS.index(kind) * 1000 + batch)
    with _captured() as want_calls:
        want = _reference_batch_predict(model, queries)
    with _captured() as got_calls:
        got = sessionrec.SeqRecAlgorithm().batch_predict(model, queries)
    assert len(got_calls) == len(want_calls)
    for (gh, gm), (wh, wm) in zip(got_calls, want_calls):
        assert gh.dtype == wh.dtype == torch.int64 and gm.dtype == wm.dtype == torch.float32
        assert torch.equal(gh, wh) and torch.equal(gm, wm)
    assert got == want
    if batch > _MAX_BUCKET and kind != "empty_or_missing":
        assert len(got_calls) > 1
    assert sorted(i for i, _ in got) == list(range(batch))


def test_packed_histories_are_built_once_and_hold_every_history():
    model = _model()
    assert model.packed is None
    alg = sessionrec.SeqRecAlgorithm()
    alg.batch_predict(model, _queries("mixed_lengths", 5, seed=1))
    packed = model.packed
    ids, spans = packed
    assert ids.dtype == np.int32 and set(spans) == set(model.histories)
    for user, history in model.histories.items():
        start, end = spans[user]
        assert ids[start:end].tolist() == history
    alg.batch_predict(model, _queries("everything", 7, seed=2))
    alg.predict(model, Query(user="u30", num=3))
    assert model.packed is packed


def test_packed_histories_are_never_saved(tmp_path):
    model = _model()
    sessionrec.save_engine_model(model, str(tmp_path / "before"))
    queries = _queries("everything", 64, seed=3)
    answers = sessionrec.SeqRecAlgorithm().batch_predict(model, queries)
    assert model.packed is not None
    sessionrec.save_engine_model(model, str(tmp_path / "after"))
    for name in ("before", "after"):
        assert sorted(os.listdir(tmp_path / name)) == ["model.json", "params.npz"]
    assert ((tmp_path / "before" / "model.json").read_bytes()
            == (tmp_path / "after" / "model.json").read_bytes())
    back = sessionrec.load_engine_model(str(tmp_path / "after"), device="cpu")
    assert back.packed is None
    assert sessionrec.SeqRecAlgorithm().batch_predict(back, queries) == answers


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_on_the_card_the_model_step_gets_tensors_already_there(cuda):
    model = _model(cuda)
    queries = _queries("everything", 300, seed=4)
    with _captured() as got_calls:
        sessionrec.SeqRecAlgorithm().batch_predict(model, queries)
    with _captured() as want_calls:
        _reference_batch_predict(model, queries)
    assert len(got_calls) == len(want_calls) > 1
    on = torch.empty(0, device=model.device).device      # "cuda" with its index
    for (gh, gm), (wh, wm) in zip(got_calls, want_calls):
        assert gh.device == gm.device == on
        assert torch.equal(gh.cpu(), wh) and torch.equal(gm.cpu(), wm)
