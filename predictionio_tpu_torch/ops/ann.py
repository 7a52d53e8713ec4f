"""ANN maximum-inner-product retrieval: an IVF-flat index and an exact
rescore (port of the JAX package's ``ops/ann.py``, one card).

- **build** (train/persist time, host NumPy, copied line for line so one
  seed builds one index in both packages): k-means over the item-factor
  table partitions the catalog into ``nlist`` cells; the membership is
  kept in CSR form: ``flat_items`` (item ids grouped by cell),
  ``flat_vecs`` (their vectors in the same order, so each cell's run is
  contiguous) and ``cell_offset``. The arrays persist through
  ``utils/checkpoint`` and live on the device while serving;
- **probe** (serving time): the query against the ``nlist`` centroids,
  the top ``nprobe`` cells, and their CSR runs walked into a shortlist
  of static width (:func:`_budget_width`: ~1.25x the mean probed mass;
  overflow drops the tail, i.e. the worst-scoring probed cells);
- **exact rescore**: the shortlist's vectors scored with the same f32
  inner product as brute force, so ranking within the shortlist is
  exact and quality loss is recall alone (:func:`quality_vs_brute`).

Seen items are masked by a sorted membership test and ``allow`` is
gathered per candidate. Slots beyond the eligible candidates carry -inf
and sentinel ids ``n_items + j``, as in ``ops/topk``'s chunked path.

Every top-k here, the probe's and the finish's, goes through
``ops/topk.topk_lowest_index``: equal centroid scores decide which cells
are probed, so the tie rule must be ``lax.top_k``'s. The products run in
true f32 (``utils/device.ieee_f32``).

The JAX package maps a batch over its rows (``lax.map``) so that each
row's runs stream through a TPU's cache; that is a cache choice, not
semantics. Here a batch runs vectorized: one (B, S, K) gather and one
batched product, each row's answer the same as at B = 1. A batch whose
gather would pass :data:`_MAX_GATHER` elements runs in row chunks, so
memory stays bounded at any batch size and probe count.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import numpy as np
import torch

from predictionio_tpu_torch.ops.topk import topk_lowest_index
from predictionio_tpu_torch.utils.device import ieee_f32, resolve_device

_NEG_INF = float("-inf")

#: below this catalog size the flat product beats any probe and gather,
#: and the index is overhead: the build refuses, serving stays brute
MIN_INDEX_ITEMS = 1024

#: bounds for the auto nlist heuristic (~sqrt(catalog), power of two)
_MIN_NLIST = 8
_MAX_NLIST = 4096


def auto_nlist(n_items: int) -> int:
    """Power-of-two cell count near 4*sqrt(catalog), the FAISS-style IVF
    band, with the mean cell floored at ~128 members."""
    if n_items <= 0:
        return _MIN_NLIST
    target = 1 << round(math.log2(max(4.0 * math.sqrt(n_items), 2.0)))
    # floor the MEAN cell size at ~128 members: finer cells on small
    # catalogs fit the sampling noise
    cap = 1 << max(int(math.log2(n_items // 128)), 3) \
        if n_items >= 1024 else _MIN_NLIST
    return max(_MIN_NLIST, min(_MAX_NLIST, target, cap))


def auto_nprobe(nlist: int) -> int:
    """Default probe count: 1/64 of the cells, floored at 16; callers
    clamp to nlist via :meth:`AnnIndex.clamp_nprobe`."""
    return max(16, nlist // 64)


#: static shortlist budget = nprobe x mean cell size x this margin; when
#: the probed runs overflow it, the tail (the worst-scoring probed cells,
#: since runs concatenate in probe-score order) is truncated
_BUDGET_MARGIN = 1.25


def _budget_width(n_items: int, nlist: int, nprobe: int,
                  rescore: int) -> int:
    """The static candidate-column count of a probe with these knobs
    (:data:`_BUDGET_MARGIN`); ``rescore > 0`` caps it."""
    mean = max(1.0, n_items / max(nlist, 1))
    width = min(n_items, int(math.ceil(nprobe * mean * _BUDGET_MARGIN)))
    if rescore > 0:
        width = min(width, rescore)
    return max(1, width)


@dataclasses.dataclass
class AnnIndex:
    """IVF-flat coarse quantizer over an item-factor table, CSR layout.

    The host NumPy arrays are canonical (they persist through the
    checkpoint envelope); device copies are made on a device's first
    query and kept."""

    nlist: int
    n_items: int
    centroids: np.ndarray    # (nlist, K) f32
    #: item ids grouped by cell: cell c's members are
    #: flat_items[cell_offset[c]:cell_offset[c+1]]
    flat_items: np.ndarray   # (n_items,) int32
    #: the member vectors in the same order, bit-identical to the factor
    #: table's rows: each probed cell rescores from one contiguous run
    flat_vecs: np.ndarray = None    # (n_items, K) f32
    cell_offset: np.ndarray = None  # (nlist + 1,) int32
    _device: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def max_cell(self) -> int:
        return int(np.diff(self.cell_offset).max())

    def device_arrays(self, device: torch.device) -> tuple:
        """(centroids, flat_items, flat_vecs, cell_offset) as tensors on
        ``device``, uploaded once per device."""
        device = torch.device(device)
        if device not in self._device:
            self._device[device] = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (self.centroids, self.flat_items, self.flat_vecs,
                          self.cell_offset))
        return self._device[device]

    def clamp_nprobe(self, nprobe: int) -> int:
        """Snap a requested probe count into [1, nlist]; 0 = auto."""
        if nprobe <= 0:
            return min(auto_nprobe(self.nlist), self.nlist)
        return min(nprobe, self.nlist)

    def shortlist_width(self, nprobe: int, rescore: int = 0) -> int:
        """The static candidate-column count a query with these knobs
        walks and rescores (budget slots included): the number
        ``/stats.json`` reports."""
        return _budget_width(self.n_items, self.nlist,
                             self.clamp_nprobe(nprobe), rescore)

    # ---- persistence (utils/checkpoint envelope) -----------------------
    def to_arrays(self) -> dict[str, np.ndarray]:
        return {
            "centroids": self.centroids,
            "flat_items": self.flat_items,
            "flat_vecs": self.flat_vecs,
            "cell_offset": self.cell_offset,
        }

    @staticmethod
    def from_arrays(arrays: Mapping[str, Any], n_items: int) -> "AnnIndex":
        centroids = np.asarray(arrays["centroids"], dtype=np.float32)
        return AnnIndex(
            nlist=int(centroids.shape[0]),
            n_items=int(n_items),
            centroids=centroids,
            flat_items=np.asarray(arrays["flat_items"], dtype=np.int32),
            flat_vecs=np.asarray(arrays["flat_vecs"], dtype=np.float32),
            cell_offset=np.asarray(arrays["cell_offset"], dtype=np.int32),
        )


# ---------------------------------------------------------------------------
# build (host NumPy; train/persist time, never on the query path)
# ---------------------------------------------------------------------------


def _assign(x: np.ndarray, centroids: np.ndarray,
            chunk: int = 65536) -> np.ndarray:
    """Nearest-centroid assignment, chunked so a million-item catalog
    never materialises the full (n, nlist) distance matrix. argmin of
    the L2 distance == argmax of (x·c - |c|^2/2)."""
    half = 0.5 * np.einsum("ck,ck->c", centroids, centroids)
    out = np.empty(len(x), dtype=np.int32)
    for lo in range(0, len(x), chunk):
        scores = x[lo:lo + chunk] @ centroids.T
        scores -= half[None, :]
        out[lo:lo + chunk] = np.argmax(scores, axis=1).astype(np.int32)
    return out


#: ranked alternative cells considered per item by the balanced
#: assignment before the any-cell-with-space fallback
_BALANCE_CHOICES = 16


def _assign_balanced(x: np.ndarray, centroids: np.ndarray, cap: int,
                     chunk: int = 65536) -> np.ndarray:
    """Capacity-bounded assignment: every cell holds at most ``cap``
    members. Items overflowing their nearest cell spill to the
    next-nearest with space (up to ``_BALANCE_CHOICES`` ranked choices,
    then any cell with room)."""
    nlist = len(centroids)
    half = 0.5 * np.einsum("ck,ck->c", centroids, centroids)
    n_choices = min(_BALANCE_CHOICES, nlist)
    choices = np.empty((len(x), n_choices), dtype=np.int32)
    for lo in range(0, len(x), chunk):
        scores = x[lo:lo + chunk] @ centroids.T
        scores -= half[None, :]
        top = np.argpartition(scores, -n_choices, axis=1)[:, -n_choices:]
        row = np.arange(len(top))[:, None]
        order = np.argsort(scores[row, top], axis=1)[:, ::-1]
        choices[lo:lo + chunk] = top[row, order].astype(np.int32)
    assign = np.full(len(x), -1, dtype=np.int32)
    counts = np.zeros(nlist, dtype=np.int64)
    for r in range(n_choices):
        unplaced = np.nonzero(assign < 0)[0]
        if not len(unplaced):
            break
        cells = choices[unplaced, r]
        order = np.argsort(cells, kind="stable")
        sorted_cells = cells[order]
        starts = np.searchsorted(sorted_cells, np.arange(nlist))
        rank = np.arange(len(sorted_cells)) - starts[sorted_cells]
        ok = rank < (cap - counts)[sorted_cells]
        assign[unplaced[order[ok]]] = sorted_cells[ok]
        counts += np.bincount(sorted_cells[ok], minlength=nlist)
    leftover = np.nonzero(assign < 0)[0]
    if len(leftover):
        space = np.repeat(np.arange(nlist, dtype=np.int32),
                          np.maximum(cap - counts, 0))
        assign[leftover] = space[:len(leftover)]
    return assign


def _host_vectors(item_f: Any) -> np.ndarray:
    """The item-factor table as contiguous host float32 rows: a tensor
    on the card or the CPU is copied to the host in f32, a NumPy array
    passes through when it already is one. (Sharded tables are ROADMAP.md
    queue 1 item 15.)"""
    if isinstance(item_f, torch.Tensor):
        return np.ascontiguousarray(item_f.detach().to(torch.float32).cpu().numpy())
    return np.ascontiguousarray(np.asarray(item_f), dtype=np.float32)


def build_index(item_f: Any, nlist: int = 0, seed: int = 0,
                iters: int = 8, sample: int = 131072,
                balance: float = 2.0) -> AnnIndex | None:
    """K-means coarse quantizer over the item-factor table: Lloyd
    iterations on a seeded sample, then one chunked full-catalog
    balanced-assignment pass (cells capped at ``balance`` x the mean);
    empty cells re-seed from random rows. None for catalogs under
    :data:`MIN_INDEX_ITEMS`."""
    x = _host_vectors(item_f)
    n = int(x.shape[0])
    if n < MIN_INDEX_ITEMS:
        return None
    nlist = nlist if nlist > 0 else auto_nlist(n)
    nlist = max(1, min(nlist, n))
    rng = np.random.default_rng(seed)
    train = x if n <= sample else x[rng.choice(n, size=sample,
                                               replace=False)]
    # a sampled fit cannot seed more centroids than sample rows: an
    # oversized explicit nlist clamps
    nlist = min(nlist, len(train))
    centroids = train[rng.choice(len(train), size=nlist,
                                 replace=False)].copy()
    for _ in range(max(1, iters)):
        assign = _assign(train, centroids)
        sums = np.zeros_like(centroids)
        np.add.at(sums, assign, train)
        counts = np.bincount(assign, minlength=nlist)
        nonempty = counts > 0
        centroids[nonempty] = (sums[nonempty]
                               / counts[nonempty, None].astype(np.float32))
        n_empty = int((~nonempty).sum())
        if n_empty:
            centroids[~nonempty] = train[rng.choice(
                len(train), size=n_empty, replace=False)]
    cap = max(1, int(math.ceil(max(balance, 1.0) * n / nlist)))
    assign = _assign_balanced(x, centroids, cap)
    counts = np.bincount(assign, minlength=nlist)
    # CSR cell grouping: the stable argsort is the flat item order, and
    # the vector copy in that order makes every cell's run contiguous
    flat_items = np.argsort(assign, kind="stable").astype(np.int32)
    cell_offset = np.concatenate(
        [[0], np.cumsum(counts)]).astype(np.int32)
    flat_vecs = np.ascontiguousarray(x[flat_items])
    return AnnIndex(nlist=nlist, n_items=n, centroids=centroids,
                    flat_items=flat_items, flat_vecs=flat_vecs,
                    cell_offset=cell_offset)


# ---------------------------------------------------------------------------
# probe + gather + exact rescore (the serving path, on the device)
# ---------------------------------------------------------------------------


def _shortlist(query_vecs: torch.Tensor, centroids: torch.Tensor,
               flat_items: torch.Tensor, flat_vecs: torch.Tensor,
               cell_offset: torch.Tensor, nprobe: int, rescore: int):
    """(candidate ids (B, S) int32, valid mask (B, S) in the query's
    dtype, candidate vectors (B, S, K)) for the top-``nprobe`` cells per
    query: the probed cells' CSR runs concatenated in probe-score order
    into the static budget width. Column j maps to (cell, offset) by a
    binary search of the probed cells' running sizes. Columns past the
    probed mass carry mask 0 (and read slot 0); probed mass past the
    budget drops from the tail."""
    n_items = int(flat_items.shape[0])
    nlist = int(cell_offset.shape[0]) - 1
    width = _budget_width(n_items, nlist, nprobe, rescore)
    with ieee_f32():
        cell_scores = query_vecs @ centroids.T
    _, probes = topk_lowest_index(cell_scores, nprobe)         # (B, P)
    offsets = cell_offset.long()
    sizes = offsets[probes + 1] - offsets[probes]
    cum = torch.cumsum(sizes, dim=1)                           # (B, P)
    b = query_vecs.shape[0]
    j = torch.arange(width, device=query_vecs.device).expand(b, width).contiguous()
    # j lands in probed cell p iff cum[p-1] <= j < cum[p]
    p = torch.searchsorted(cum, j, right=True).clamp(0, probes.shape[1] - 1)
    prev = torch.where(p > 0, cum.gather(1, (p - 1).clamp(min=0)), 0)
    valid = j < cum[:, -1:]
    flat = torch.where(valid, offsets[probes.gather(1, p)] + (j - prev), 0)
    cand = flat_items[flat]
    vecs = flat_vecs[flat]
    return cand, valid.to(query_vecs.dtype), vecs


def _mask_seen(cand: torch.Tensor, scores: torch.Tensor, seen_cols: torch.Tensor,
               seen_mask: torch.Tensor) -> torch.Tensor:
    """-inf out candidates present in each row's seen list by a sorted
    membership test: each row's seen ids sorted (pad slots pushed to
    int32-max, which no catalog index reaches), every candidate
    binary-searched and compared at its insertion point."""
    big = int(np.iinfo(np.int32).max)
    seen = torch.where(seen_mask > 0, seen_cols.long(), big).sort(dim=1).values
    cand = cand.long()
    pos = torch.searchsorted(seen, cand).clamp(0, seen.shape[1] - 1)
    hit = seen.gather(1, pos) == cand
    return torch.where(hit, _NEG_INF, scores)


def _finish(cand: torch.Tensor, scores: torch.Tensor, k: int,
            n_items: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the shortlist: ``k`` clamps to the shortlist width,
    and -inf slots carry the sentinel ids ``n_items + j``, never a pad
    or duplicate candidate's. Indices are int64."""
    k = min(k, scores.shape[1])
    vals, sel = topk_lowest_index(scores, k)
    idxs = cand.gather(1, sel).long()
    sentinels = n_items + torch.arange(k, device=cand.device)[None, :]
    return vals, torch.where(torch.isfinite(vals), idxs, sentinels)


def _eligible(scores: torch.Tensor, pad_mask: torch.Tensor, cand: torch.Tensor,
              allow: torch.Tensor) -> torch.Tensor:
    """Pad slots and candidates that ``allow`` (1-D, or one row per
    query) rules out become -inf."""
    scores = torch.where(pad_mask > 0, scores, _NEG_INF)
    cand = cand.long()
    allowed = allow[cand] if allow.ndim == 1 else allow.gather(1, cand)
    return torch.where(allowed > 0, scores, _NEG_INF)


#: elements of one (B, S, K) candidate gather (256 MiB in f32) beyond
#: which a batch runs in row chunks
_MAX_GATHER = 1 << 26


def _row_step(b: int, flat_vecs: torch.Tensor, cell_offset: torch.Tensor, nprobe: int,
              rescore: int) -> int:
    """Rows per chunk: all ``b`` unless their gather passes _MAX_GATHER."""
    width = _budget_width(int(flat_vecs.shape[0]), int(cell_offset.shape[0]) - 1, nprobe,
                          rescore)
    return max(1, min(b, _MAX_GATHER // (width * int(flat_vecs.shape[1]))))


def _by_rows(fn, step: int, query: torch.Tensor, cols: torch.Tensor, mask: torch.Tensor,
             allow: torch.Tensor, *rest) -> tuple[torch.Tensor, torch.Tensor]:
    """``fn`` over row chunks of ``step`` (the per-row arguments sliced,
    a 1-D ``allow`` shared), results concatenated."""
    parts = [fn(query[i:i + step], *rest[:5], cols[i:i + step], mask[i:i + step],
                allow if allow.ndim == 1 else allow[i:i + step], *rest[5:])
             for i in range(0, query.shape[0], step)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def ann_topk(user_vecs: torch.Tensor, item_f: torch.Tensor, centroids: torch.Tensor,
             flat_items: torch.Tensor, flat_vecs: torch.Tensor, cell_offset: torch.Tensor,
             seen_cols: torch.Tensor, seen_mask: torch.Tensor, allow: torch.Tensor,
             k: int, nprobe: int, rescore: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """ANN counterpart of ``ops/topk.recommend_topk``: probe the
    top-``nprobe`` cells, walk their CSR runs as the shortlist, rescore
    it with the true inner product, mask seen and ineligible candidates,
    top-k. ``user_vecs`` (B, K), ``seen_cols``/``seen_mask`` (B, S),
    ``allow`` (I,) or (B, I). Results are in global item coordinates,
    (B, min(k, width)); ``item_f`` gives only the sentinel base."""
    step = _row_step(user_vecs.shape[0], flat_vecs, cell_offset, nprobe, rescore)
    if step < user_vecs.shape[0]:
        return _by_rows(ann_topk, step, user_vecs, seen_cols, seen_mask, allow, item_f,
                        centroids, flat_items, flat_vecs, cell_offset, k, nprobe, rescore)
    cand, pad_mask, vecs = _shortlist(user_vecs, centroids, flat_items, flat_vecs,
                                      cell_offset, nprobe, rescore)
    with ieee_f32():
        scores = torch.bmm(vecs, user_vecs[:, :, None])[:, :, 0]   # exact rescore
    scores = _eligible(scores, pad_mask, cand, allow)
    scores = _mask_seen(cand, scores, seen_cols, seen_mask)
    return _finish(cand, scores, k, item_f.shape[0])


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-9)


def ann_similar_topk(query_vecs: torch.Tensor, item_f: torch.Tensor, centroids: torch.Tensor,
                     flat_items: torch.Tensor, flat_vecs: torch.Tensor,
                     cell_offset: torch.Tensor, exclude_cols: torch.Tensor,
                     exclude_mask: torch.Tensor, allow: torch.Tensor, k: int, nprobe: int,
                     rescore: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """ANN counterpart of ``ops/topk.similar_topk`` (cosine): the same
    index, probed and rescored in the normalized space (the query, the
    centroids and the candidate runs normalized, norms clamped at
    1e-9)."""
    step = _row_step(query_vecs.shape[0], flat_vecs, cell_offset, nprobe, rescore)
    if step < query_vecs.shape[0]:
        return _by_rows(ann_similar_topk, step, query_vecs, exclude_cols, exclude_mask,
                        allow, item_f, centroids, flat_items, flat_vecs, cell_offset, k,
                        nprobe, rescore)
    qn = _unit(query_vecs)
    cand, pad_mask, vecs = _shortlist(qn, _unit(centroids), flat_items, flat_vecs,
                                      cell_offset, nprobe, rescore)
    with ieee_f32():
        scores = torch.bmm(_unit(vecs), qn[:, :, None])[:, :, 0]
    scores = _eligible(scores, pad_mask, cand, allow)
    scores = _mask_seen(cand, scores, exclude_cols, exclude_mask)
    return _finish(cand, scores, k, item_f.shape[0])


# ---------------------------------------------------------------------------
# quality measurement (tests/test_torch_ann.py and chip_smoke.py)
# ---------------------------------------------------------------------------


def quality_vs_brute(index: AnnIndex, user_vecs: Any, item_f: Any, k: int = 10,
                     nprobe: int = 0, rescore: int = 0,
                     device: str | torch.device | None = None) -> dict:
    """Recall@shortlist and MAP@k of the ANN ranking against brute force
    as ground truth, computed on ``item_f``'s device (a tensor's own,
    else ``device``, default ``cuda``).

    - ``recall_at_shortlist``: the share of each query's true top-k
      (exact full-catalog MIPS) that landed in the probed shortlist;
    - ``map_at_k``: mean average precision of the ANN top-k with the
      brute top-k as the relevant set (brute scores 1.0)."""
    from predictionio_tpu_torch.ops import topk as topk_ops

    dev = item_f.device if isinstance(item_f, torch.Tensor) else resolve_device(device)
    nprobe = index.clamp_nprobe(nprobe)
    uv = torch.as_tensor(np.asarray(user_vecs, dtype=np.float32)
                         if not isinstance(user_vecs, torch.Tensor) else user_vecs,
                         dtype=torch.float32, device=dev)
    itf = torch.as_tensor(item_f, dtype=torch.float32, device=dev)
    b = int(uv.shape[0])
    no_seen_cols = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    no_seen_mask = torch.zeros((b, 1), dtype=torch.float32, device=dev)
    allow = torch.ones((itf.shape[0],), dtype=torch.float32, device=dev)
    bv, bi = topk_ops.recommend_topk(uv, itf, no_seen_cols, no_seen_mask, allow,
                                     min(k, int(itf.shape[0])))
    centroids, flat_items, flat_vecs, cell_offset = index.device_arrays(dev)
    cand, pad_mask, _ = _shortlist(uv, centroids, flat_items, flat_vecs, cell_offset,
                                   nprobe, rescore)
    av, ai = ann_topk(uv, itf, centroids, flat_items, flat_vecs, cell_offset,
                      no_seen_cols, no_seen_mask, allow, k, nprobe, rescore)
    bi_h, bv_h = bi.cpu().numpy(), bv.cpu().numpy()
    ai_h, av_h = ai.cpu().numpy(), av.cpu().numpy()
    cand_h = np.where(pad_mask.cpu().numpy() > 0, cand.cpu().numpy(), -1)
    recalls, aps = [], []
    for row in range(b):
        truth = [int(i) for i, v in zip(bi_h[row], bv_h[row])
                 if np.isfinite(v)]
        if not truth:
            continue
        shortlist = set(int(c) for c in cand_h[row] if c >= 0)
        recalls.append(sum(1 for i in truth if i in shortlist) / len(truth))
        relevant = set(truth)
        hits, precision_sum = 0, 0.0
        ranked = [int(i) for i, v in zip(ai_h[row], av_h[row])
                  if np.isfinite(v)][:k]
        for rank, item in enumerate(ranked, start=1):
            if item in relevant:
                hits += 1
                precision_sum += hits / rank
        aps.append(precision_sum / min(k, len(relevant)))
    return {
        "recall_at_shortlist": float(np.mean(recalls)) if recalls else 1.0,
        "map_at_k": float(np.mean(aps)) if aps else 1.0,
        "k": k,
        "nprobe": nprobe,
        "shortlist_width": index.shortlist_width(nprobe, rescore),
        "queries": len(recalls),
    }
