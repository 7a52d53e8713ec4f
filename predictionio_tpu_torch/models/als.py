"""The ALS model of the recommendation-family templates (port of the JAX
package's ``models/als.py``, one card).

It holds the trained factor tables, resident on the device between
requests, the entity-id ↔ dense-index maps and each user's seen items.
Queries go through the masked top-k of ``ops/topk.py`` (brute force) or,
with ``configure_retrieval("ann")``, the IVF probe and exact rescore of
``ops/ann.py``. With an online overlay installed (``online/``, ``pio
deploy --online``), folded users and brand-new items are served between
retrains. A model saves as the JAX package saves one with its npz
checkpoint backend (``utils/checkpoint.py`` + ``model.json``, the ANN
index under ``ann/``), so either package loads the other's models.
Sharded serving is ROADMAP.md queue 1 item 15.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Mapping, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.ops import ann as ann_ops
from predictionio_tpu_torch.ops import topk as topk_ops
from predictionio_tpu_torch.utils.bimap import BiMap, EntityIdIxMap
from predictionio_tpu_torch.utils.checkpoint import (
    default_mmap_mode,
    host_tensor,
    load_sharded,
    save_sharded,
)
from predictionio_tpu_torch.utils.device import ieee_f32, resolve_device

logger = logging.getLogger(__name__)

#: serving-time pad length of a query's seen-item list; a longer history
#: folds into the allow vector, never truncates
_SEEN_PAD = 512

#: the model-directory subdirectory of the ANN index's checkpoint
_ANN_SUBDIR = "ann"


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
    #: IVF-flat index over item_factors (ops/ann.AnnIndex), built at
    #: persist time and saved beside the factors; None = brute only
    ann_index: ann_ops.AnnIndex | None = dataclasses.field(default=None, repr=False,
                                                           compare=False)
    #: serving retrieval ("brute" | "ann") and its knobs: deployment
    #: config set by configure_retrieval, never saved
    retrieval: str = dataclasses.field(default="brute", compare=False)
    ann_nprobe: int = dataclasses.field(default=0, compare=False)
    ann_rescore: int = dataclasses.field(default=0, compare=False)
    #: callable(shortlist_width, queries) the serving layer installs to
    #: count ANN queries (api/stats.ServingStats.record_ann)
    _ann_observer: object = dataclasses.field(default=None, repr=False, compare=False)
    #: the fold-in service's delta overlay (online/overlay.OnlineOverlay)
    online_overlay: object = dataclasses.field(default=None, repr=False, compare=False)

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

    # ---- retrieval (ops/ann) ----------------------------------------------
    def configure_retrieval(self, mode: str = "brute", nprobe: int = 0, rescore: int = 0,
                            nlist: int = 0, observer=None) -> None:
        """Apply the deployment's retrieval knobs. ``ann`` on a model saved
        without an index builds one here (deploy time); a catalog too
        small to index serves brute force, with a warning."""
        if mode == "ann" and self.ann_index is None:
            built = ann_ops.build_index(self.item_factors, nlist=nlist)
            if built is None:
                logger.warning(
                    "retrieval=ann requested but the catalog has only %d items (< %d): "
                    "serving brute force", self.item_factors.shape[0],
                    ann_ops.MIN_INDEX_ITEMS)
                mode = "brute"
            else:
                logger.info(
                    "retrieval=ann: built the IVF index at deploy time (nlist=%d, max "
                    "cell=%d); `pio train` builds it once at persist time",
                    built.nlist, built.max_cell)
                self.ann_index = built
        self.retrieval = mode
        self.ann_nprobe = max(0, int(nprobe))
        self.ann_rescore = max(0, int(rescore))
        self._ann_observer = observer

    def set_ann_observer(self, observer) -> None:
        """Install the serving layer's ANN query counter
        (callable(shortlist_width, queries))."""
        self._ann_observer = observer

    @property
    def ann_enabled(self) -> bool:
        """True when queries are answered through the ANN index (mode
        configured and an index present)."""
        return self._ann_active()

    def _ann_active(self) -> bool:
        return self.retrieval == "ann" and self.ann_index is not None

    def _ann_args(self) -> tuple:
        """(device arrays..., nprobe, rescore), nprobe clamped to the
        index."""
        index = self.ann_index
        return (*index.device_arrays(self.device), index.clamp_nprobe(self.ann_nprobe),
                self.ann_rescore)

    def _record_ann(self, width: int, queries: int) -> None:
        if self._ann_observer is not None:
            self._ann_observer(width, queries)

    # ---- the online freshness overlay (online/) ----------------------------
    def set_online_overlay(self, overlay) -> None:
        """Install the fold-in service's delta overlay: queries of folded
        users and, while overlay items exist, every recommendation query
        take the overlay-aware path."""
        self.online_overlay = overlay

    def online_delta(self, user_id: str):
        """The user's fold-in delta, or None (no overlay, or not folded)."""
        overlay = self.online_overlay
        return overlay.user(user_id) if overlay is not None else None

    def needs_online_path(self, user_id: str) -> bool:
        """True when a query of ``user_id`` must take the single-query
        overlay-aware path instead of the batched one: folded users, and
        everyone while overlay items exist (the batched path scores only
        the base catalog)."""
        overlay = self.online_overlay
        if overlay is None:
            return False
        return overlay.has_items() or overlay.user(user_id) is not None

    # ---- serving ---------------------------------------------------------
    def _allow_or_default(self, allow) -> torch.Tensor:
        if allow is not None:
            return torch.as_tensor(allow, dtype=torch.float32, device=self.device)
        if self._default_allow is None:
            self._default_allow = torch.ones((self.item_factors.shape[0],),
                                             dtype=torch.float32, device=self.device)
        return self._default_allow

    def _topk(self, query: torch.Tensor, cols: torch.Tensor, mask: torch.Tensor, allow,
              k: int, similar: bool = False,
              brute: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """(values, indices) of the configured retrieval for (B, K) query
        vectors: ANN (counted by the observer) or, when not configured or
        ``brute``, brute force. ANN clamps ``k`` to its shortlist width."""
        allow_v = self._allow_or_default(allow)
        if self._ann_active() and not brute:
            *arrays, nprobe, rescore = self._ann_args()
            fn = ann_ops.ann_similar_topk if similar else ann_ops.ann_topk
            out = fn(query, self.item_factors, *arrays, cols, mask, allow_v, k, nprobe,
                     rescore)
            self._record_ann(self.ann_index.shortlist_width(nprobe, rescore),
                             int(query.shape[0]))
            return out
        fn = topk_ops.similar_topk if similar else topk_ops.recommend_topk
        return fn(query, self.item_factors, cols, mask, allow_v, k)

    def _single_query(self, query: torch.Tensor, ixs: np.ndarray, allow, num: int,
                      similar: bool = False,
                      brute: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """One query vector (1, K) against the catalog: ``ixs`` (at most
        _SEEN_PAD) are hidden, in one upload; (values, indices) come back
        in one download."""
        buf = np.zeros((2 * _SEEN_PAD,), dtype=np.int32)
        buf[: len(ixs)] = ixs
        buf[_SEEN_PAD : _SEEN_PAD + len(ixs)] = 1
        packed = torch.from_numpy(buf).to(self.device)
        k = min(_serving_k(num), self.item_factors.shape[0])
        vals, idxs = self._topk(query, packed[None, :_SEEN_PAD], packed[None, _SEEN_PAD:],
                                allow, k, similar, brute)
        k = vals.shape[1]
        out = torch.cat([vals[0].view(torch.int32), idxs[0].int()]).cpu().numpy()
        return out[:k].view(np.float32), out[k:]

    @staticmethod
    def _fold_overflow(seen: np.ndarray, allow, n_items: int):
        """Past the packed width a history folds into the allow vector
        (exclude_seen is a correctness contract): (seen[:_SEEN_PAD],
        allow)."""
        if len(seen) <= _SEEN_PAD:
            return seen, allow
        allow = (np.ones((n_items,), dtype=np.float32) if allow is None
                 else np.asarray(allow, dtype=np.float32).copy())
        allow[seen[_SEEN_PAD:]] = 0.0
        return seen[:_SEEN_PAD], allow

    def recommend(self, user_id: str, num: int, allow: np.ndarray | None = None,
                  exclude_seen: bool = True) -> list[tuple[str, float]]:
        """Top-``num`` unseen items for one user; [] for an unknown user
        (the reference template's behaviour) unless the online overlay
        folded a vector for them."""
        overlay = self.online_overlay
        delta = overlay.user(user_id) if overlay is not None else None
        if delta is not None or (overlay is not None and overlay.has_items()):
            return self._recommend_online(user_id, delta, num, allow, exclude_seen)
        uix = self.user_ids.get(user_id)
        if uix is None:
            return []
        seen = (self.seen_by_user.get(uix, np.empty(0, dtype=np.int32))
                if exclude_seen else np.empty(0, dtype=np.int32))
        seen, allow = self._fold_overflow(seen, allow, self.item_factors.shape[0])
        return self._gather_results(*self._single_query(
            self.user_factors[uix : uix + 1], seen, allow, num), num)

    def _recommend_online(self, user_id: str, delta, num: int, allow: np.ndarray | None,
                          exclude_seen: bool) -> list[tuple[str, float]]:
        """The overlay-aware path: the folded query vector when a delta
        exists (else the base row), the base seen list united with the
        post-training item indices the fold recorded, and, for unfiltered
        queries, the overlay's new items scored on the host and merged
        into the configured retrieval's top-k (the index is never rebuilt
        online, so unchanged items rank as without the overlay)."""
        uix = self.user_ids.get(user_id)
        if delta is not None:
            uv = np.asarray(delta.vector, dtype=np.float32)
        elif uix is not None:
            uv = self.user_factors[uix].float().cpu().numpy()
        else:
            return []
        # before the overflow fold below: overlay items are outside the
        # catalog-indexed allow vector, so filtered queries serve the
        # base catalog only
        caller_filtered = allow is not None
        seen = np.empty(0, dtype=np.int32)
        if exclude_seen:
            parts = ([self.seen_by_user.get(uix, np.empty(0, dtype=np.int32))]
                     if uix is not None else [])
            if delta is not None and delta.extra_seen:
                parts.append(np.asarray(delta.extra_seen, dtype=np.int32))
            if parts:
                seen = np.unique(np.concatenate(parts)).astype(np.int32)
        seen, allow = self._fold_overflow(seen, allow, self.item_factors.shape[0])
        query = torch.from_numpy(uv[None, :].copy()).to(self.device)
        base = self._gather_results(*self._single_query(query, seen, allow, num), num)
        if caller_filtered:
            return base[:num]
        overlay = self.online_overlay
        snap = overlay.delta_matrix() if overlay is not None else None
        if snap is None:
            return base[:num]
        ids, matrix = snap
        scores = matrix @ uv
        hidden = set(delta.delta_seen) if (delta is not None and exclude_seen) else ()
        merged = base + [(iid, float(s)) for iid, s in zip(ids, scores) if iid not in hidden]
        merged.sort(key=lambda kv: kv[1], reverse=True)
        return merged[:num]

    def similar(self, item_id_list: Sequence[str], num: int,
                allow: np.ndarray | None = None) -> list[tuple[str, float]]:
        """Top-``num`` items most similar (cosine) to the mean of the query
        items, never one of them; unknown items are skipped, [] when none
        is known. A list longer than _SEEN_PAD is averaged whole, excludes
        its first _SEEN_PAD items and is scored by brute force, as in the
        JAX package."""
        ixs = [self.item_ids.get(i) for i in item_id_list]
        ixs = np.asarray([i for i in ixs if i is not None], dtype=np.int32)
        if not len(ixs):
            return []
        qvec = self.item_factors[torch.from_numpy(ixs).to(self.device).long()].mean(
            0, keepdim=True)
        return self._gather_results(*self._single_query(
            qvec, ixs[:_SEEN_PAD], allow, num, similar=True, brute=len(ixs) > _SEEN_PAD), num)

    def batch_topk(self, uixs: np.ndarray, seen_cols, seen_mask, allow,
                   k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Masked top-k over dense user indices, the templates'
        batch_predict path: ANN when configured, else flat or chunked by
        ``recommend_topk_fused``. ``allow=None`` uses the all-ones
        vector."""
        uv = self.user_factors[torch.as_tensor(np.asarray(uixs), device=self.device).long()]
        if self._ann_active():
            return self._topk(uv, torch.as_tensor(seen_cols, device=self.device).long(),
                              torch.as_tensor(seen_mask, device=self.device).float(),
                              allow, k)
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
        the JAX package's ``ALSModel.load`` reads.

        The ANN index is built here, at persist time, when the catalog
        holds at least ``ops/ann.MIN_INDEX_ITEMS`` items, and saved in the
        same checksummed envelope under ``ann/`` with an ``"ann"`` entry
        in ``model.json``, as the JAX package does:
        ``PIO_SERVING_ANN_NLIST`` overrides the auto cell count and
        ``PIO_SERVING_ANN_BUILD=0`` skips the build."""
        os.makedirs(directory, exist_ok=True)
        save_sharded(directory, {"user": self.user_factors.cpu().numpy(),
                                 "item": self.item_factors.cpu().numpy()})
        build = os.environ.get("PIO_SERVING_ANN_BUILD", "1").strip().lower()
        if self.ann_index is None and build not in ("0", "false", "off"):
            try:
                nlist = int(os.environ.get("PIO_SERVING_ANN_NLIST", "0"))
            except ValueError:
                nlist = 0
            self.ann_index = ann_ops.build_index(self.item_factors, nlist=nlist)
        if self.ann_index is not None:
            save_sharded(os.path.join(directory, _ANN_SUBDIR), self.ann_index.to_arrays())
        meta = {
            "rank": self.rank,
            "user_ids": self.user_ids.id_to_ix.to_dict(),
            "item_ids": self.item_ids.id_to_ix.to_dict(),
            "seen": {str(k): np.asarray(v).tolist() for k, v in self.seen_by_user.items()},
            **({"ann": {"nlist": self.ann_index.nlist, "n_items": self.ann_index.n_items}}
               if self.ann_index is not None else {}),
        }
        with open(os.path.join(directory, "model.json"), "w") as f:
            json.dump(meta, f)

    @staticmethod
    def load(directory: str, device: str | torch.device | None = None) -> "ALSModel":
        """A model saved by :meth:`save` or by the JAX package with its npz
        backend, on ``device`` (default ``cuda``). When ``model.json``
        names an ANN index, ``ann/`` is read and verified: a missing or
        torn payload raises ``CheckpointCorruptError``. The model serves
        brute force until ``configure_retrieval("ann")``.

        Under ``PIO_CHECKPOINT_MMAP=r`` (``pio deploy --model-mmap``) the
        factor tables and the index's arrays are mapped, so the workers
        of a pool share one host copy (``utils/checkpoint.host_tensor``:
        on the CPU the tables are the read-only mapping itself)."""
        dev = resolve_device(device)
        with open(os.path.join(directory, "model.json")) as f:
            meta = json.load(f)
        data = load_sharded(directory)
        ann_index = None
        if "ann" in meta:
            # the index rides the same knob as the factors: flat_vecs is
            # a full f32 copy of the item table, and from_arrays keeps a
            # dtype-matching mapping as a view
            ann_index = ann_ops.AnnIndex.from_arrays(
                load_sharded(os.path.join(directory, _ANN_SUBDIR),
                             mmap_mode=default_mmap_mode()),
                n_items=int(meta["ann"]["n_items"]))
        return ALSModel(
            rank=int(meta["rank"]),
            user_factors=host_tensor(data["user"], dev),
            item_factors=host_tensor(data["item"], dev),
            user_ids=EntityIdIxMap(BiMap({k: int(v) for k, v in meta["user_ids"].items()})),
            item_ids=EntityIdIxMap(BiMap({k: int(v) for k, v in meta["item_ids"].items()})),
            seen_by_user={int(k): np.asarray(v, dtype=np.int32)
                          for k, v in meta["seen"].items()},
            ann_index=ann_index)


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
