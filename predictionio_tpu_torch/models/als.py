"""The ALS model of the recommendation-family templates (port of the JAX
package's ``models/als.py``, brute-force retrieval on one card).

It holds the trained factor tables, resident on the device between
requests, the entity-id ↔ dense-index maps and each user's seen items.
Queries go through the masked top-k of ``ops/topk.py``. A model saves as
the JAX package saves one with its npz checkpoint backend
(``utils/checkpoint.py`` + ``model.json``), so either package loads the
other's models. Not in this slice: ANN retrieval (ROADMAP.md queue 1
item 10), the online freshness overlay (item 11) and sharded serving
(item 15).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.ops import topk as topk_ops
from predictionio_tpu_torch.utils.bimap import BiMap, EntityIdIxMap
from predictionio_tpu_torch.utils.checkpoint import load_sharded, save_sharded
from predictionio_tpu_torch.utils.device import ieee_f32, resolve_device

#: serving-time pad length of a query's seen-item list; a longer history
#: folds into the allow vector, never truncates
_SEEN_PAD = 512


def _serving_k(k: int) -> int:
    """``k`` rounded up to the shared serving top-k menu (call sites
    clamp to the catalog)."""
    return topk_ops.serving_k(k, 1 << 62)


@dataclasses.dataclass
class ALSModel:
    """Factors + id maps + seen lists; the factors stay on the device."""

    rank: int
    user_factors: torch.Tensor          # (U, K) f32
    item_factors: torch.Tensor          # (I, K) f32
    user_ids: EntityIdIxMap
    item_ids: EntityIdIxMap
    seen_by_user: Mapping[int, np.ndarray]  # user ix -> seen item ix array
    # the all-ones eligibility vector on the device, built once
    _default_allow: torch.Tensor | None = dataclasses.field(default=None, repr=False,
                                                            compare=False)

    @property
    def device(self) -> torch.device:
        return self.item_factors.device

    @staticmethod
    def from_jax(user_factors: np.ndarray, item_factors: np.ndarray,
                 user_ids: Mapping[str, int], item_ids: Mapping[str, int],
                 seen_by_user: Mapping[int, Sequence[int]],
                 device: str | torch.device | None = None) -> "ALSModel":
        """A JAX-trained model from its arrays: the factor tables as NumPy
        (``np.asarray`` of the JAX model's), its id maps as dicts, its
        seen lists."""
        dev = resolve_device(device)
        user_factors, item_factors = params_from_jax(user_factors, item_factors)
        return ALSModel(
            rank=int(item_factors.shape[1]),
            user_factors=user_factors.to(dev),
            item_factors=item_factors.to(dev),
            user_ids=EntityIdIxMap(BiMap(dict(user_ids))),
            item_ids=EntityIdIxMap(BiMap(dict(item_ids))),
            seen_by_user={int(u): np.asarray(s, dtype=np.int32)
                          for u, s in seen_by_user.items()})

    # ---- retrieval that later slices add ---------------------------------
    def configure_retrieval(self, mode: str = "brute", **knobs) -> None:
        """Brute force is the one retrieval of this slice; the ANN knobs
        (nprobe, rescore, nlist, observer) come with it."""
        if mode != "brute":
            raise NotImplementedError(
                f"retrieval={mode!r} is not ported: ROADMAP.md queue 1 item 10, "
                "ANN retrieval")

    def set_online_overlay(self, overlay) -> None:
        raise NotImplementedError(
            "the online freshness overlay is not ported: ROADMAP.md queue 1 item 11")

    def online_delta(self, user_id: str):
        """The user's fold-in delta: None, since no overlay can be set in
        this slice (the JAX package's answer with no overlay)."""
        return None

    def needs_online_path(self, user_id: str) -> bool:
        """No overlay in this slice: every query may take the batch path."""
        return False

    # ---- serving ---------------------------------------------------------
    def _allow_or_default(self, allow) -> torch.Tensor:
        if allow is not None:
            return torch.as_tensor(allow, dtype=torch.float32, device=self.device)
        if self._default_allow is None:
            self._default_allow = torch.ones((self.item_factors.shape[0],),
                                             dtype=torch.float32, device=self.device)
        return self._default_allow

    def _single_query(self, topk_fn, query: torch.Tensor, ixs: np.ndarray, allow,
                      num: int) -> list[tuple[str, float]]:
        """One query vector (1, K) against the catalog: ``ixs`` (at most
        _SEEN_PAD) are hidden, in one upload; values and indices come back
        in one download."""
        buf = np.zeros((2 * _SEEN_PAD,), dtype=np.int32)
        buf[: len(ixs)] = ixs
        buf[_SEEN_PAD : _SEEN_PAD + len(ixs)] = 1
        packed = torch.from_numpy(buf).to(self.device)
        k = min(_serving_k(num), self.item_factors.shape[0])
        vals, idxs = topk_fn(query, self.item_factors, packed[None, :_SEEN_PAD],
                             packed[None, _SEEN_PAD:], self._allow_or_default(allow), k)
        out = torch.cat([vals[0].view(torch.int32), idxs[0].int()]).cpu().numpy()
        return self._gather_results(out[:k].view(np.float32), out[k:], num)

    def recommend(self, user_id: str, num: int, allow: np.ndarray | None = None,
                  exclude_seen: bool = True) -> list[tuple[str, float]]:
        """Top-``num`` unseen items for one user; [] for an unknown user
        (the reference template's behaviour)."""
        uix = self.user_ids.get(user_id)
        if uix is None:
            return []
        seen = (self.seen_by_user.get(uix, np.empty(0, dtype=np.int32))
                if exclude_seen else np.empty(0, dtype=np.int32))
        if len(seen) > _SEEN_PAD:
            # exclude_seen is a correctness contract: past the packed
            # width the history folds into the allow vector
            allow = (np.ones((self.item_factors.shape[0],), dtype=np.float32)
                     if allow is None else np.asarray(allow, dtype=np.float32).copy())
            allow[seen[_SEEN_PAD:]] = 0.0
            seen = seen[:_SEEN_PAD]
        return self._single_query(topk_ops.recommend_topk,
                                  self.user_factors[uix : uix + 1], seen, allow, num)

    def similar(self, item_id_list: Sequence[str], num: int,
                allow: np.ndarray | None = None) -> list[tuple[str, float]]:
        """Top-``num`` items most similar (cosine) to the mean of the query
        items, never one of them; unknown items are skipped, [] when none
        is known. A list longer than _SEEN_PAD is averaged whole and
        excludes its first _SEEN_PAD items, as in the JAX package."""
        ixs = [self.item_ids.get(i) for i in item_id_list]
        ixs = np.asarray([i for i in ixs if i is not None], dtype=np.int32)
        if not len(ixs):
            return []
        qvec = self.item_factors[torch.from_numpy(ixs).to(self.device).long()].mean(
            0, keepdim=True)
        return self._single_query(topk_ops.similar_topk, qvec, ixs[:_SEEN_PAD], allow, num)

    def batch_topk(self, uixs: np.ndarray, seen_cols, seen_mask, allow,
                   k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Masked top-k over dense user indices, the templates'
        batch_predict path: flat or chunked by ``recommend_topk_fused``.
        ``allow=None`` uses the all-ones vector."""
        uv = self.user_factors[torch.as_tensor(np.asarray(uixs), device=self.device).long()]
        return topk_ops.recommend_topk_fused(uv, self.item_factors, seen_cols, seen_mask,
                                             self._allow_or_default(allow), k)

    def predict_rating(self, user_id: str, item_id: str) -> float | None:
        uix = self.user_ids.get(user_id)
        iix = self.item_ids.get(item_id)
        if uix is None or iix is None:
            return None
        with ieee_f32():
            return float(self.user_factors[uix] @ self.item_factors[iix])

    def _gather_results(self, vals, idxs, num: int) -> list[tuple[str, float]]:
        inv = self.item_ids.inverse
        out = []
        for v, i in zip(np.asarray(vals)[:num], np.asarray(idxs)[:num]):
            if not np.isfinite(v):
                break  # masked slots sort last
            out.append((inv[int(i)], float(v)))
        return out

    # ---- persistence -----------------------------------------------------
    def save(self, directory: str) -> None:
        """The factor tables through ``utils/checkpoint.save_sharded``
        (npz) and ``model.json`` (rank, id maps, seen lists), the layout
        the JAX package's ``ALSModel.load`` reads."""
        os.makedirs(directory, exist_ok=True)
        save_sharded(directory, {"user": self.user_factors.cpu().numpy(),
                                 "item": self.item_factors.cpu().numpy()})
        meta = {
            "rank": self.rank,
            "user_ids": self.user_ids.id_to_ix.to_dict(),
            "item_ids": self.item_ids.id_to_ix.to_dict(),
            "seen": {str(k): np.asarray(v).tolist() for k, v in self.seen_by_user.items()},
        }
        with open(os.path.join(directory, "model.json"), "w") as f:
            json.dump(meta, f)

    @staticmethod
    def load(directory: str, device: str | torch.device | None = None) -> "ALSModel":
        """A model saved by :meth:`save` or by the JAX package with its npz
        backend, on ``device`` (default ``cuda``). An ``ann/`` index in the
        directory is not read: the model serves brute force, the JAX
        package's default retrieval."""
        dev = resolve_device(device)
        with open(os.path.join(directory, "model.json")) as f:
            meta = json.load(f)
        data = load_sharded(directory)
        return ALSModel(
            rank=int(meta["rank"]),
            user_factors=torch.from_numpy(data["user"]).to(dev),
            item_factors=torch.from_numpy(data["item"]).to(dev),
            user_ids=EntityIdIxMap(BiMap({k: int(v) for k, v in meta["user_ids"].items()})),
            item_ids=EntityIdIxMap(BiMap({k: int(v) for k, v in meta["item_ids"].items()})),
            seen_by_user={int(k): np.asarray(v, dtype=np.int32)
                          for k, v in meta["seen"].items()})


def params_from_jax(user_factors: np.ndarray,
                    item_factors: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX factor tables (NumPy) as f32 host tensors."""
    return (torch.from_numpy(np.array(user_factors, dtype=np.float32)),
            torch.from_numpy(np.array(item_factors, dtype=np.float32)))


def build_allow_vector(item_ids, *, categories=None, category_map=None, white_list=None,
                       black_list=None) -> np.ndarray | None:
    """Dense 0/1 eligibility vector from the template business rules: None
    = no restriction; an EMPTY white list or category set means nothing
    is eligible; black-listed items are always out."""
    n = len(item_ids)
    if categories is None and white_list is None and not black_list:
        return None
    allow = None
    if categories is not None:
        wanted = set(categories)
        allow = np.zeros(n, dtype=np.float32)
        for item_id, cats in (category_map or {}).items():
            ix = item_ids.get(item_id)
            if ix is not None and wanted & set(cats):
                allow[ix] = 1.0
    if white_list is not None:
        wl = np.zeros(n, dtype=np.float32)
        for item_id in white_list:
            ix = item_ids.get(item_id)
            if ix is not None:
                wl[ix] = 1.0
        allow = wl if allow is None else allow * wl
    if allow is None:
        allow = np.ones(n, dtype=np.float32)
    for item_id in black_list or ():
        ix = item_ids.get(item_id)
        if ix is not None:
            allow[ix] = 0.0
    return allow
