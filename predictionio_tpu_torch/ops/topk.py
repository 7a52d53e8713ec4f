"""Masked top-k scoring, the recommendation serving path (port of the
JAX package's ``ops/topk.py``).

One product of the query vectors with the item-factor table, the
eligibility mask, a scatter-min that hides each query's seen items, and
:func:`topk_lowest_index`, which orders equal scores as ``lax.top_k``
does. Every function clamps ``k`` to the catalog and never asserts.
Products run in true f32, whatever the process set for TF32.
:func:`recommend_topk_sharded` is the distributed top-k over a device
mesh (``parallel/mesh.py``): local top-k per catalog shard, an
all-gather of the candidates, a global merge.
"""

from __future__ import annotations

import numpy as np
import torch

from predictionio_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    ShardedArray,
    all_gather,
    axis_index,
    data_sharding,
    device_put,
)
from predictionio_tpu_torch.utils.device import ieee_f32

_NEG_INF = float("-inf")
_POS_INF = float("inf")


def topk_lowest_index(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``torch.topk`` over the last dim with ``lax.top_k``'s tie rule:
    values descending, equal values by ascending index, which also
    decides which tied slots make the cut (``torch.topk`` states no
    order for ties). Every site of the port's top-k calls this.

    The values' f32 bits are mapped to int32 keys that order as
    ``lax.top_k`` orders the floats (+0.0 above -0.0), and one top-k of
    the keys gives the k-th key ``t``. Every slot above ``t`` made the
    cut; the slots equal to ``t`` that it kept (the last ``kept``) are
    replaced by the first ``kept`` slots equal to ``t`` in index order,
    found by a binary search of the running count of such slots, so no
    host read is needed. Last, the k survivors are ordered by (key
    descending, index ascending). Values come back in ``x``'s dtype;
    indices are int64."""
    bits = x.float().contiguous().view(torch.int32)
    keys = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    kv, idx = torch.topk(keys, k)
    t = kv[..., -1:]
    kept = (kv == t).sum(-1, keepdim=True)
    ties_so_far = torch.cumsum(keys == t, -1, dtype=torch.int32)
    j = torch.arange(k, device=x.device)
    nth = (j - (k - kept) + 1).clamp(min=1).to(torch.int32)
    idx = torch.where(j >= k - kept, torch.searchsorted(ties_so_far, nth), idx)
    order = torch.argsort(kv.long() * (1 << 32) + (0xFFFFFFFF - idx), dim=-1, descending=True)
    idx = idx.gather(-1, order)
    return x.gather(-1, idx), idx


def topk_scores(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the top-k per row, ``k`` clamped to the
    column count."""
    return topk_lowest_index(scores, min(k, scores.shape[-1]))


def _hide(scores: torch.Tensor, cols: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Scatter-min: real (mask > 0) slots write -inf, padded ones +inf,
    which changes nothing."""
    hide = torch.where(mask > 0, _NEG_INF, _POS_INF).to(scores.dtype)
    return scores.scatter_reduce_(1, cols.long(), hide, "amin")


def recommend_topk(user_vecs: torch.Tensor, item_f: torch.Tensor, seen_cols: torch.Tensor,
                   seen_mask: torch.Tensor, allow: torch.Tensor,
                   k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k unseen, eligible items per query.

    ``user_vecs`` (B, K), ``item_f`` (I, K), ``seen_cols``/``seen_mask``
    (B, S) padded item indices and 1=real/0=pad, ``allow`` (I,) or
    (B, I) 0/1 eligibility. Returns (B, min(k, I)) values and int64
    indices; masked slots carry -inf."""
    with ieee_f32():
        scores = user_vecs @ item_f.T
    scores = torch.where(allow > 0, scores, _NEG_INF)
    return topk_lowest_index(_hide(scores, seen_cols, seen_mask), min(k, scores.shape[-1]))


def recommend_topk_chunked(user_vecs: torch.Tensor, item_f: torch.Tensor,
                           seen_cols: torch.Tensor, seen_mask: torch.Tensor,
                           allow: torch.Tensor, k: int,
                           chunk: int = 1 << 18) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`recommend_topk` without the (B, I) score matrix: item tiles
    of ``chunk`` rows (views of the table), a top-k per tile and a
    running merge; peak memory O(B × chunk). A catalog that ``chunk``
    does not divide ends with an overlapping tile whose already-scored
    prefix is masked. ``allow`` must be 1-D.

    Agrees with the flat path on every finite slot. Slots beyond the
    eligible items carry -inf and sentinel indices ``>= I``, never a
    real item's: the merge concatenates the carry before the tile, so
    the tie rule of :func:`topk_lowest_index` keeps the carry's -inf
    sentinels ahead of the tile's masked slots, as ``lax.top_k`` does
    in the JAX package's merge. Equal finite scores merge in global
    index order: the carry holds lower indices than the tile, and in the
    overlap tile the already-scored prefix is -inf."""
    B, I = user_vecs.shape[0], item_f.shape[0]
    k = min(k, I)
    if I <= chunk:
        return recommend_topk(user_vecs, item_f, seen_cols, seen_mask, allow, k)
    starts = [t * chunk for t in range(I // chunk)]
    valid_from = list(starts)
    if I % chunk:
        starts.append(I - chunk)
        valid_from.append((I // chunk) * chunk)
    dev = user_vecs.device
    seen_cols = seen_cols.long()
    bv = torch.full((B, k), _NEG_INF, dtype=torch.float32, device=dev)
    bi = (I + torch.arange(k, device=dev)).expand(B, k)
    for start, vfrom in zip(starts, valid_from):
        with ieee_f32():
            scores = user_vecs @ item_f[start:start + chunk].T
        scores = torch.where(allow[start:start + chunk] > 0, scores, _NEG_INF)
        if vfrom > start:
            scores[:, : vfrom - start] = _NEG_INF
        # seen items in tile coordinates; the others clip to column 0
        # and write +inf, which changes nothing
        local = seen_cols - start
        in_tile = (local >= 0) & (local < chunk) & (seen_mask > 0)
        _hide(scores, local.clamp(0, chunk - 1), in_tile)
        bv, sel = topk_lowest_index(torch.cat([bv, scores], dim=1), k)
        bi = torch.where(sel < k, bi.gather(1, sel.clamp(max=k - 1)), start + sel - k)
    return bv, bi


def recommend_topk_sharded(user_vecs, item_f: torch.Tensor | ShardedArray, seen_cols,
                           seen_mask, allow, k: int,
                           mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """The distributed batch top-k over ``mesh``: queries split over
    "data", the item table's rows over "model". Each position scores its
    queries against its catalog shard, masks them (eligibility, and the
    seen items that fall in its shard, in shard-local ids) and keeps a
    local top-k of ``min(k, shard rows)``; the ``n_model * k_loc``
    candidates are all-gathered over "model" (candidates, never the (B, I)
    scores) and merged into the global top-k in global item ids.

    Equal scores keep the lower global index first, as everywhere in the
    port: each local top-k is :func:`topk_lowest_index`, and the gathered
    candidates are shard-major, so a lower position is a lower index
    among equal scores for the merge's own :func:`topk_lowest_index`.

    ``k`` clamps to the catalog; a batch that does not divide "data" is
    padded with zero queries whose results are cut off. The catalog must
    divide "model" (``item_f`` is persistent sharded state: callers pad
    it once, ``models/als.py`` does), or this raises. Inputs may be
    tensors or NumPy (``item_f`` also a table row-sharded over "model");
    values and int64 indices come back on the mesh's first device."""
    n_model, n_data = mesh.axis_size("model"), mesh.axis_size("data")
    I = item_f.shape[0]
    if I % n_model:
        raise ValueError(f"catalog rows ({I}) must divide the model axis ({n_model}); "
                         "pad the item table")
    if not isinstance(item_f, ShardedArray) or item_f.mesh is not mesh \
            or item_f.spec[0] != "model":
        item_f = device_put(item_f.gather() if isinstance(item_f, ShardedArray) else item_f,
                            NamedSharding(mesh, ("model", None)))
    k = min(k, I)
    home = mesh.device(mesh.home)
    uv = torch.as_tensor(user_vecs).to(home, torch.float32)
    sc = torch.as_tensor(seen_cols).to(home, torch.int64)
    sm = torch.as_tensor(seen_mask).to(home, torch.float32)
    b = uv.shape[0]
    pad = (-b) % n_data
    if pad:
        uv, sc, sm = (torch.cat([x, x.new_zeros((pad, x.shape[1]))]) for x in (uv, sc, sm))
    uv_s, sc_s, sm_s = (device_put(x, data_sharding(mesh, 2)) for x in (uv, sc, sm))
    al_s = device_put(torch.as_tensor(allow).to(home, torch.float32),
                      NamedSharding(mesh, ("model",)))
    rows = I // n_model
    k_loc = min(k, rows)   # a shard contributes at most its own rows
    vals, idxs = {}, {}
    for pos in mesh.local_positions:
        start = axis_index(mesh, pos, "model") * rows
        with ieee_f32():
            scores = uv_s.local(pos) @ item_f.local(pos).T              # (b, rows)
        scores = torch.where(al_s.local(pos) > 0, scores, _NEG_INF)
        loc = sc_s.local(pos) - start
        in_shard = (loc >= 0) & (loc < rows) & (sm_s.local(pos) > 0)
        _hide(scores, loc.clamp(0, rows - 1), in_shard)
        v, i = topk_lowest_index(scores, k_loc)
        vals[pos], idxs[pos] = v, i + start
    cand_v, cand_i = (all_gather(ShardedArray.from_local(mesh, ("data", "model"), x.get),
                                 "model") for x in (vals, idxs))
    out_v, out_i = [], []
    for d in range(n_data):   # the merge is replicated over "model": read at index 0
        pos = next(p for p in mesh.local_positions if axis_index(mesh, p, "data") == d
                   and axis_index(mesh, p, "model") == 0)
        v, sel = topk_lowest_index(cand_v.local(pos), k)
        out_v.append(v.to(home))
        out_i.append(cand_i.local(pos).gather(1, sel).to(home))
    return torch.cat(out_v)[:b], torch.cat(out_i)[:b]


#: seen-array widths of ``batch_predict``'s menu
_SEEN_WIDTHS = (8, 32, 128, 512)

#: batch widths (powers of two) that serving batches pad to
BATCH_WIDTHS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def serving_batch(b: int) -> int:
    """Round a serving batch size up to the ``BATCH_WIDTHS`` menu;
    batches beyond it pass through unchanged."""
    if b <= 0:
        return BATCH_WIDTHS[0]
    if b > BATCH_WIDTHS[-1] or (b & (b - 1)) == 0:
        return b
    return 1 << b.bit_length()


#: top-k widths shared by every serving path: ``query.num`` is
#: client-controlled, and a small menu keeps the set of distinct top-k
#: shapes the device sees bounded
_K_WIDTHS = (10, 32, 100, 320, 1000)


def serving_k(k: int, n_max: int) -> int:
    """Round a requested top-k width up to the ``_K_WIDTHS`` menu
    (power of two beyond it), clamped to the catalog/vocab size.
    Callers trim results to each query's own num."""
    for cap in _K_WIDTHS:
        if k <= cap:
            return min(cap, n_max)
    return min(1 << (max(k, 2) - 1).bit_length(), n_max)


#: catalog and batch sizes from which :func:`recommend_topk_fused` takes
#: the chunked path: the JAX package's values, measured on a TPU
_MIN_ITEMS = 786_432
_MIN_BATCH = 24


def _trim_seen(seen_cols, seen_mask):
    """Shrink host (NumPy) seen arrays to the smallest ``_SEEN_WIDTHS``
    width that covers the last occupied slot; tensors and menu-width
    arrays pass through."""
    if not isinstance(seen_mask, np.ndarray) or seen_mask.ndim != 2 \
            or seen_mask.shape[1] in _SEEN_WIDTHS:
        return seen_cols, seen_mask
    occupied = np.where(seen_mask > 0,
                        np.arange(1, seen_mask.shape[1] + 1, dtype=np.int64)[None, :], 0)
    real = int(occupied.max()) if occupied.size else 0
    for width in _SEEN_WIDTHS:
        if real <= width < seen_mask.shape[1]:
            return seen_cols[:, :width], seen_mask[:, :width]
    return seen_cols, seen_mask


def _on(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(dtype)


def recommend_topk_fused(user_vecs: torch.Tensor, item_f: torch.Tensor, seen_cols,
                         seen_mask, allow: torch.Tensor,
                         k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k dispatcher: the chunked path for a 1-D ``allow``, a catalog
    of at least ``_MIN_ITEMS`` and a batch of at least ``_MIN_BATCH``
    (its host seen arrays trimmed first), else the flat path. Seen
    arrays may be NumPy or tensors."""
    if allow.ndim == 1 and item_f.shape[0] >= _MIN_ITEMS \
            and user_vecs.shape[0] >= _MIN_BATCH:
        seen_cols, seen_mask = _trim_seen(seen_cols, seen_mask)
        return recommend_topk_chunked(
            user_vecs, item_f, _on(seen_cols, item_f.device, torch.int64),
            _on(seen_mask, item_f.device, torch.float32), allow, k)
    return recommend_topk(user_vecs, item_f, _on(seen_cols, item_f.device, torch.int64),
                          _on(seen_mask, item_f.device, torch.float32), allow, k)


def similar_topk(query_vecs: torch.Tensor, item_f: torch.Tensor, exclude_cols: torch.Tensor,
                 exclude_mask: torch.Tensor, allow: torch.Tensor,
                 k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Cosine-similarity top-k (the similarproduct ranking): both sides
    normalized (norms clamped at 1e-9), eligibility and exclusion as in
    :func:`recommend_topk`."""
    qn = query_vecs / query_vecs.norm(dim=-1, keepdim=True).clamp_min(1e-9)
    itn = item_f / item_f.norm(dim=-1, keepdim=True).clamp_min(1e-9)
    with ieee_f32():
        scores = qn @ itn.T
    scores = torch.where(allow > 0, scores, _NEG_INF)
    return topk_lowest_index(_hide(scores, exclude_cols, exclude_mask),
                             min(k, scores.shape[-1]))
