"""Alternating least squares on one card (port of the JAX package's
``ops/als.py``).

Explicit ratings train ALS-WR (``λ·n_u`` on the diagonal), implicit
feedback trains Hu-Koren-Volinsky with MLlib ``trainImplicit``'s
negative-rating rule, as MLlib's ``ALS.train``/``ALS.trainImplicit`` do
in the reference templates.

Layouts (``als_train(layout=...)``), each packed on the host and staged
on the device as ``(S, B, L)`` slabs of the JAX package's shapes:

- ``fused`` (what "auto" picks): every row's ratings in ONE bucket
  padded to the ladder ``LADDER_COUNTS × 128`` (or ``small`` for light
  rows) by :func:`ladder_rows`, staged once by :func:`stage_buckets`;
- ``bucketed``: whole rows in power-of-``growth`` buckets
  (:func:`bucket_rows`), the only layout with ``max_row_len`` (a heavy
  row keeps its top-valued ratings) and ``hbm_resident=False``
  (:func:`solve_half` stages one bucket at a time and frees it after its
  solve);
- ``chunked``: rows cut into fixed-size chunks (:func:`chunk_rows`,
  :func:`stage_chunks`); each chunk's partial normal equations are added
  into a per-row ``(num_rows, K, K)`` accumulator with ``index_add_``,
  then one batched solve covers every row.

A whole-row half-step gathers ``F = V[cols]`` per slab, builds the
per-row normal equations with batched products (bf16 operands accumulate
in f32), solves them with batched conjugate gradients
(:func:`_cg_solve_batched`) or Cholesky, and writes the rows back with
``index_copy_``. Where XLA runs a training as one program, the port runs
an eager Python loop over iterations, buckets and slabs; the loop never
reads a device value on the host.

The host layouts pack in C++ (``native/bucketize.cc``: ``pio_ladder``,
``pio_bucketize``, ``pio_chunk``; built with g++ at first use), with the
NumPy paths as the fallback and the oracle.

Over a device mesh (``parallel/mesh.py``, ``als_train(mesh=...)``) the
slab rows split over the "data" axis, padded to its multiple; each
position solves its data shard's rows (replicated over "model", as in
the JAX package's program, and solved once on a device that stands at
several positions along "model"), and each solved row goes to the shard
that owns it. With ``shard_factors=True`` and a "model" axis > 1
(DP×MP, the BASELINE configuration) both factor tables stay row-sharded
over "model" between half-steps of the fused layout, and each half-step
all-gathers the opposite table once for its slab gathers. A whole row's
normal equations are built at one position, so its solve is the
unsharded one's; the chunked layout sums per-position accumulators
(``psum``), which reorders its additions.
"""

from __future__ import annotations

import ctypes
import dataclasses
import logging
import math
import os
from typing import Sequence

import numpy as np
import torch

from predictionio_tpu_torch import native
from predictionio_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    ShardedArray,
    all_gather,
    axis_index,
    device_put,
    model_sharding,
    per_device,
    psum,
    replicated,
)
from predictionio_tpu_torch.utils.device import ieee_f32, resolve_device

logger = logging.getLogger(__name__)

#: layouts packed by the native ``pio_ladder``, ``pio_bucketize`` and
#: ``pio_chunk`` in this process (the NumPy paths count none):
#: ``chip_smoke.py`` reads them to show that the native packers served
NATIVE_LADDERS = 0
NATIVE_BUCKETS = 0
NATIVE_CHUNKS = 0


# ---------------------------------------------------------------------------
# Host layouts: COO ratings -> padded slabs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RatingsCOO:
    """Host ratings triple; rows/cols are dense indices (see utils.bimap)."""

    rows: np.ndarray  # int32 (R,)
    cols: np.ndarray  # int32 (R,)
    vals: np.ndarray  # float32 (R,)
    num_rows: int
    num_cols: int

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def transpose(self) -> "RatingsCOO":
        return RatingsCOO(self.cols, self.rows, self.vals, self.num_cols, self.num_rows)


@dataclasses.dataclass(frozen=True)
class Bucket:
    """All rows whose degree pads to ``pad_len``: dense (n, pad_len) slabs,
    entries packed to the row prefix (the pad mask is ``iota < deg``)."""

    row_ids: np.ndarray  # int32 (n,) original row indices
    cols: np.ndarray     # int32 (n, pad_len)
    vals: np.ndarray     # float32 (n, pad_len)
    deg: np.ndarray      # int32 (n,) real entries per row

    @property
    def pad_len(self) -> int:
        return int(self.cols.shape[1])

    @property
    def mask(self) -> np.ndarray:
        """(n, pad_len) f32 — 1 for real entries, 0 for padding."""
        return (np.arange(self.pad_len, dtype=np.int32)[None, :]
                < self.deg[:, None]).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class BucketedRatings:
    buckets: tuple[Bucket, ...]
    num_rows: int
    num_cols: int
    nnz: int


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _native_coo_args(coo: RatingsCOO):
    """Contiguous (rows, cols, vals) of ``coo`` and their typed pointers
    for the native entry points. The arrays must stay referenced while
    the native handle lives."""
    rows = np.ascontiguousarray(coo.rows, dtype=np.int32)
    cols = np.ascontiguousarray(coo.cols, dtype=np.int32)
    vals = np.ascontiguousarray(coo.vals, dtype=np.float32)
    return (rows, cols, vals, _ptr(rows, ctypes.c_int32), _ptr(cols, ctypes.c_int32),
            _ptr(vals, ctypes.c_float))


def _native_read_slabs(handle, num_fn, info_fn, fill_fn, free_fn, make):
    """The readback loop of the handle-based native layouts (bucketizer
    and chunker share one (ids, cols, vals, deg) slab contract): each
    slab's shape, then NumPy buffers the native side fills; the handle is
    freed. None when a call fails."""
    i32, f32 = ctypes.c_int32, ctypes.c_float
    try:
        out = []
        for b in range(num_fn(handle)):
            length, n = ctypes.c_int32(), ctypes.c_int64()
            if info_fn(handle, b, ctypes.byref(length), ctypes.byref(n)):
                return None
            pl, nn = int(length.value), int(n.value)
            ids = np.empty((nn,), dtype=np.int32)
            cols = np.empty((nn, pl), dtype=np.int32)
            vals = np.empty((nn, pl), dtype=np.float32)
            deg = np.empty((nn,), dtype=np.int32)
            if fill_fn(handle, b, _ptr(ids, i32), _ptr(cols, i32), _ptr(vals, f32),
                       _ptr(deg, i32)):
                return None
            out.append(make(ids, cols, vals, deg))
        return tuple(out)
    finally:
        free_fn(handle)


def _read_buckets(lib, handle) -> tuple[Bucket, ...] | None:
    return _native_read_slabs(handle, lib.pio_bucketize_num_buckets,
                              lib.pio_bucketize_bucket_info, lib.pio_bucketize_fill,
                              lib.pio_bucketize_free, Bucket)


def _bucket_rows_native(coo: RatingsCOO, min_len: int, growth: int,
                        max_len: int | None) -> BucketedRatings | None:
    """The C++ packing path (``native/bucketize.cc`` ``pio_bucketize``);
    None when the library cannot be built or refuses the input."""
    global NATIVE_BUCKETS
    lib = native.load_bucketize()
    if lib is None or coo.nnz == 0:
        return None
    rows, cols, vals, rp, cp, vp = _native_coo_args(coo)
    handle = lib.pio_bucketize(coo.nnz, rp, cp, vp, coo.num_rows, min_len, growth,
                               0 if max_len is None else max_len)
    if not handle:
        return None
    buckets = _read_buckets(lib, handle)
    if buckets is None:
        return None
    NATIVE_BUCKETS += 1
    return BucketedRatings(buckets, coo.num_rows, coo.num_cols, coo.nnz)


def bucket_rows(coo: RatingsCOO, min_len: int = 8, growth: int = 2,
                max_len: int | None = None, use_native: bool = True) -> BucketedRatings:
    """Whole rows in padded power-of-``growth`` buckets — the layout of
    ``layout="bucketed"``. ``max_len`` caps a row's kept ratings, the
    highest-valued kept. With ``use_native`` the C++ packer builds it
    where it can be built (a capped row may keep other columns at tied
    values than the NumPy path, the same multiset of values); the NumPy
    path below is the JAX package's."""
    if use_native:
        packed = _bucket_rows_native(coo, min_len, growth, max_len)
        if packed is not None:
            return packed
    order = np.argsort(coo.rows, kind="stable")
    rows = coo.rows[order]
    cols = coo.cols[order]
    vals = coo.vals[order]
    uniq, start, counts = np.unique(rows, return_index=True, return_counts=True)

    capped = np.minimum(counts, max_len) if max_len is not None else counts
    # bucket length per unique row: min_len * growth^k >= count
    lens = np.maximum(capped, min_len)
    exps = np.ceil(np.log(lens / min_len) / np.log(growth) - 1e-12).astype(np.int64)
    pad_lens = (min_len * growth ** np.maximum(exps, 0)).astype(np.int64)

    buckets = []
    for pl in np.unique(pad_lens):
        sel = np.nonzero(pad_lens == pl)[0]
        n = len(sel)
        b_cols = np.zeros((n, pl), dtype=np.int32)
        b_vals = np.zeros((n, pl), dtype=np.float32)
        for j, ui in enumerate(sel):
            s, c = start[ui], capped[ui]
            if c < counts[ui]:   # keep the top-valued ratings of a capped row
                seg = np.argsort(vals[s: s + counts[ui]])[::-1][:c] + s
            else:
                seg = slice(s, s + c)
            b_cols[j, :c] = cols[seg]
            b_vals[j, :c] = vals[seg]
        buckets.append(Bucket(uniq[sel].astype(np.int32), b_cols, b_vals,
                              capped[sel].astype(np.int32)))
    return BucketedRatings(tuple(buckets), coo.num_rows, coo.num_cols, coo.nnz)


# ---------------------------------------------------------------------------
# Chunked layout: rows cut into fixed-size chunks, accumulated per row
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChunkSlab:
    """All chunks of one length ``L``: dense (n, L) slabs and the row each
    chunk belongs to. Chunks of one row add up on the device."""

    row_ids: np.ndarray  # int32 (n,) owning row per chunk
    cols: np.ndarray     # int32 (n, L)
    vals: np.ndarray     # float32 (n, L)
    deg: np.ndarray      # int32 (n,) real entries in this chunk


@dataclasses.dataclass(frozen=True)
class ChunkedRatings:
    slabs: tuple[ChunkSlab, ...]   # one per chunk size, descending L
    num_rows: int
    num_cols: int
    nnz: int


def _chunk_rows_native(coo: RatingsCOO, sizes: Sequence[int]) -> ChunkedRatings | None:
    """The C++ chunking path (``native/bucketize.cc`` ``pio_chunk*``);
    None when the library cannot be built or refuses the input."""
    global NATIVE_CHUNKS
    lib = native.load_bucketize()
    if lib is None or coo.nnz == 0:
        return None
    rows, cols, vals, rp, cp, vp = _native_coo_args(coo)
    sz = np.ascontiguousarray(sizes, dtype=np.int32)
    handle = lib.pio_chunk(coo.nnz, rp, cp, vp, coo.num_rows, _ptr(sz, ctypes.c_int32),
                           len(sz))
    if not handle:
        return None
    slabs = _native_read_slabs(handle, lib.pio_chunk_num_slabs, lib.pio_chunk_slab_info,
                               lib.pio_chunk_fill, lib.pio_chunk_free, ChunkSlab)
    if slabs is None:
        return None
    NATIVE_CHUNKS += 1
    return ChunkedRatings(slabs, coo.num_rows, coo.num_cols, coo.nnz)


def chunk_rows(coo: RatingsCOO, sizes: Sequence[int] = (512, 128),
               use_native: bool = True) -> ChunkedRatings:
    """Every row cut into fixed-size chunks — the layout of
    ``layout="chunked"``. Greedy: full chunks of the largest size first,
    cascading down; the last remainder pads to the smallest size. No
    rating is dropped and padding is under the smallest size per row.
    With ``use_native`` the C++ packer builds it where it can be built;
    the NumPy path below, the JAX package's, builds the same slabs."""
    sizes = sorted({int(s) for s in sizes}, reverse=True)
    if not sizes or sizes[-1] < 1:
        raise ValueError(f"invalid chunk sizes {sizes}")
    if use_native:
        packed = _chunk_rows_native(coo, sizes)
        if packed is not None:
            return packed
    order = np.argsort(coo.rows, kind="stable")
    rows_s = coo.rows[order]
    cols_s = coo.cols[order]
    vals_s = coo.vals[order]
    deg = np.bincount(rows_s, minlength=coo.num_rows).astype(np.int64)
    start = np.zeros(coo.num_rows, dtype=np.int64)
    np.cumsum(deg[:-1], out=start[1:])
    pos = np.arange(coo.nnz, dtype=np.int64) - start[rows_s]   # within its row

    slabs = []
    # per-row entry offset where each size class begins (the cascade)
    class_begin = np.zeros(coo.num_rows, dtype=np.int64)
    remaining = deg.copy()
    for i, L in enumerate(sizes):
        if i < len(sizes) - 1:
            n_full = remaining // L           # only full chunks of this size
            covered = n_full * L
        else:
            n_full = -(-remaining // L)       # the remainder pads to the last size
            covered = remaining
        class_end = class_begin + covered
        sel = (pos >= class_begin[rows_s]) & (pos < class_end[rows_s])
        chunk_base = np.zeros(coo.num_rows, dtype=np.int64)
        np.cumsum(n_full[:-1], out=chunk_base[1:])
        total = int(n_full.sum())
        if total:
            p = pos[sel] - class_begin[rows_s[sel]]
            chunk_of = chunk_base[rows_s[sel]] + p // L
            within = p % L
            b_cols = np.zeros((total, L), dtype=np.int32)
            b_vals = np.zeros((total, L), dtype=np.float32)
            b_cols[chunk_of, within] = cols_s[sel]
            b_vals[chunk_of, within] = vals_s[sel]
            b_deg = np.bincount(chunk_of, minlength=total).astype(np.int32)
            has = n_full > 0
            b_rows = np.repeat(np.nonzero(has)[0].astype(np.int32), n_full[has])
            slabs.append(ChunkSlab(b_rows, b_cols, b_vals, b_deg))
        class_begin = class_end
        remaining = remaining - covered
    return ChunkedRatings(tuple(slabs), coo.num_rows, coo.num_cols, coo.nnz)


# ---------------------------------------------------------------------------
# Ladder layout: the fused path's whole-row buckets
# ---------------------------------------------------------------------------

#: pad-length ladder for :func:`ladder_rows`, in units of 128-entry
#: chunks; count padding is bounded by the gap ratio (<= 1.5x)
LADDER_COUNTS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128,
                 192, 256, 384, 512, 768, 1024, 1536, 2048)


def _ladder_rows_native(coo: RatingsCOO, width: int, small: int) -> BucketedRatings | None:
    """The C++ packing path (``native/bucketize.cc`` ``pio_ladder``: one
    counting sort and one fill, behind the ``pio_bucketize_*`` handle
    calls); None when the library cannot be built or refuses the input."""
    global NATIVE_LADDERS
    lib = native.load_bucketize()
    if lib is None or coo.nnz == 0:
        return None
    rows, cols, vals, rp, cp, vp = _native_coo_args(coo)
    ladder = np.ascontiguousarray(LADDER_COUNTS, dtype=np.int64)
    handle = lib.pio_ladder(coo.nnz, rp, cp, vp, coo.num_rows, width, small,
                            _ptr(ladder, ctypes.c_int64), len(ladder))
    if not handle:
        return None
    buckets = _read_buckets(lib, handle)
    if buckets is None:
        return None
    NATIVE_LADDERS += 1
    return BucketedRatings(buckets, coo.num_rows, coo.num_cols, coo.nnz)


def ladder_rows(coo: RatingsCOO, width: int = 128, small: int = 64,
                use_native: bool = True) -> BucketedRatings:
    """Whole-row buckets padded to the ladder — the layout of
    ``layout="fused"``. A row of degree ``<= small`` pads to ``small``;
    any other to ``width * c``, ``c`` the smallest :data:`LADDER_COUNTS`
    entry covering ``ceil(deg / width)`` (doubling past the end). No
    rating is dropped. With ``use_native`` the C++ packer
    (:func:`_ladder_rows_native`) builds it where it can be built; the
    NumPy path below, the JAX package's, builds the same slabs."""
    if use_native:
        packed = _ladder_rows_native(coo, width, small)
        if packed is not None:
            return packed
    if coo.nnz == 0:
        return BucketedRatings((), coo.num_rows, coo.num_cols, 0)
    order = np.argsort(coo.rows, kind="stable")
    rows_s = coo.rows[order]
    cols_s = coo.cols[order]
    vals_s = coo.vals[order]
    deg = np.bincount(rows_s, minlength=coo.num_rows).astype(np.int64)
    start = np.zeros(coo.num_rows, dtype=np.int64)
    np.cumsum(deg[:-1], out=start[1:])
    pos = np.arange(coo.nnz, dtype=np.int64) - start[rows_s]

    counts = list(LADDER_COUNTS)
    need = -(-deg // width)                       # ceil chunks per row
    top = int(need.max()) if len(need) else 1
    while counts[-1] < top:
        counts.append(counts[-1] * 2)
    counts = np.asarray(counts, dtype=np.int64)
    pad_lens = counts[np.searchsorted(counts, need)] * width
    pad_lens = np.where((deg > 0) & (deg <= small), small, pad_lens)

    # one stable sort groups entries by bucket (row/pos order kept), so
    # each bucket's entries are a contiguous slice
    ekey = pad_lens[rows_s]
    e_order = np.argsort(ekey, kind="stable")
    key_b = ekey[e_order]
    rows_b, cols_b = rows_s[e_order], cols_s[e_order]
    vals_b, pos_b = vals_s[e_order], pos[e_order]

    act_rows = np.nonzero(deg > 0)[0]
    sorted_rows = act_rows[np.argsort(pad_lens[act_rows], kind="stable")]
    sorted_pl = pad_lens[sorted_rows]
    slot_of = np.empty(coo.num_rows, dtype=np.int64)

    buckets = []
    for pl in np.unique(sorted_pl):
        rs, re_ = np.searchsorted(sorted_pl, [pl, pl + 1])
        sel_rows = sorted_rows[rs:re_]
        slot_of[sel_rows] = np.arange(re_ - rs)
        es, ee = np.searchsorted(key_b, [pl, pl + 1])
        b_cols = np.zeros((re_ - rs, pl), dtype=np.int32)
        b_vals = np.zeros((re_ - rs, pl), dtype=np.float32)
        slots = slot_of[rows_b[es:ee]]
        b_cols[slots, pos_b[es:ee]] = cols_b[es:ee]
        b_vals[slots, pos_b[es:ee]] = vals_b[es:ee]
        buckets.append(Bucket(sel_rows.astype(np.int32), b_cols, b_vals,
                              deg[sel_rows].astype(np.int32)))
    return BucketedRatings(tuple(buckets), coo.num_rows, coo.num_cols, coo.nnz)


#: CG step cap: batched f32 CG on ridge-regularised ALS normal matrices
#: reaches its f32 accuracy floor by step 16 on every system family the
#: JAX package measured (its ``_CG_STEP_CAP`` note)
_CG_STEP_CAP = 16

#: caps on one slab's gathered (B, L, K) rows and its (B, K, K) normal
#: matrices, in elements; sized for a TPU core's VMEM and kept for
#: slab-shape parity with the JAX package
_MAX_SLAB_ELEMS = 1 << 24
_MAX_SOLVE_ELEMS = 8 << 20


def _slab_shape(n: int, pad_len: int, rank: int, data_axis: int,
                max_slab_elems: int) -> tuple[int, int]:
    """(num_slabs, slab_rows): slab_rows a multiple of ``data_axis`` (the
    mesh's "data" axis; 1 without a mesh) with slab_rows*pad_len*rank <=
    max_slab_elems and slab_rows*rank^2 <= _MAX_SOLVE_ELEMS."""
    b = max(1, max_slab_elems // (pad_len * rank))
    b = min(b, max(1, _MAX_SOLVE_ELEMS // (rank * rank)))
    b = max(data_axis, (b // data_axis) * data_axis)
    b = min(b, ((n + data_axis - 1) // data_axis) * data_axis)
    return (n + b - 1) // b, b


def half_step_flops(bucketed: BucketedRatings | ChunkedRatings, rank: int,
                    max_slab_elems: int = _MAX_SLAB_ELEMS, cg_steps: int | None = None,
                    solver: str = "cg") -> dict[str, float]:
    """Useful vs executed FLOPs of one half-step on this layout. Useful:
    ``2K² + 2K`` per real rating and the Cholesky minimum ``K³/3 + 2K²``
    per rated row. Executed: every padded slab entry, and the solve as the
    solver runs it (CG: ``steps × (2K² + 8K)``) — on the chunked layout
    for every row, since unrated rows solve the identity."""
    if solver not in ("cg", "cholesky"):
        raise ValueError(f"solver must be 'cg' or 'cholesky', got {solver!r}")
    k = float(rank)
    per_entry = 2.0 * k * k + 2.0 * k
    per_solve = (k ** 3) / 3.0 + 2.0 * k * k
    if solver == "cholesky":
        per_solve_exec = per_solve
    else:
        steps = cg_steps if cg_steps is not None else min(rank + 4, _CG_STEP_CAP)
        per_solve_exec = float(steps) * (2.0 * k * k + 8.0 * k)
    useful = executed = 0.0
    if isinstance(bucketed, ChunkedRatings):
        active = set()
        for slab in bucketed.slabs:
            n, L = slab.cols.shape
            useful += float(slab.deg.sum()) * per_entry
            active.update(np.unique(slab.row_ids).tolist())
            s, rows = _slab_shape(n, L, rank, 1, max_slab_elems)
            executed += float(s * rows) * L * per_entry
        useful += len(active) * per_solve
        executed += bucketed.num_rows * per_solve_exec
        return {"useful_flops": useful, "executed_flops": executed}
    for b in bucketed.buckets:
        n = int(b.row_ids.shape[0])
        useful += float(b.deg.sum()) * per_entry + n * per_solve
        s, rows = _slab_shape(n, b.pad_len, rank, 1, max_slab_elems)
        executed += float(s * rows) * (b.pad_len * per_entry + per_solve_exec)
    return {"useful_flops": useful, "executed_flops": executed}


# ---------------------------------------------------------------------------
# Device staging: pad layouts into slabs, resident or one bucket at a time
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceBucket:
    """One bucket on the device as (S, B, L) slabs; pad rows have degree 0.
    Staged over a mesh, every field is a :class:`ShardedArray` split over
    "data" along B, and ``row_ids`` is (S, B) with -1 at pad rows."""

    row_ids: torch.Tensor | ShardedArray  # int64 (n,), or (S, B) over a mesh
    cols: torch.Tensor | ShardedArray     # int32 (S, B, L)
    vals: torch.Tensor | ShardedArray     # float32 (S, B, L), zero-padded
    deg: torch.Tensor | ShardedArray      # int32 (S, B)
    n: int
    pad_len: int


@dataclasses.dataclass(frozen=True)
class DeviceBucketedRatings:
    """Whole-row buckets resident on the device: build once with
    :func:`stage_buckets` and reuse across every iteration."""

    buckets: tuple[DeviceBucket, ...]
    num_rows: int
    num_cols: int
    nnz: int


@dataclasses.dataclass(frozen=True)
class DeviceChunkSlab:
    """One chunk slab on the device (over a mesh, each field split over
    "data" along B)."""

    row_ids: torch.Tensor | ShardedArray  # int64 (S, B) owning row (0 for pad chunks)
    cols: torch.Tensor | ShardedArray     # int32 (S, B, L)
    vals: torch.Tensor | ShardedArray     # float32 (S, B, L)
    deg: torch.Tensor | ShardedArray      # int32 (S, B) real entries (0 for pad chunks)


@dataclasses.dataclass(frozen=True)
class DeviceChunkedRatings:
    """Chunk slabs resident on the device: build once with
    :func:`stage_chunks`."""

    slabs: tuple[DeviceChunkSlab, ...]
    num_rows: int
    num_cols: int
    nnz: int


def _pad_rows(a: np.ndarray, s: int, b: int) -> np.ndarray:
    """``a``'s rows zero-padded to ``s * b`` and shaped (s, b, ...)."""
    p = np.zeros((s * b, *a.shape[1:]), dtype=a.dtype)
    p[: a.shape[0]] = a
    return p.reshape(s, b, *a.shape[1:])


def pad_bucket_slabs(bucket: Bucket, rank: int, max_slab_elems: int,
                     data_axis: int = 1) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One bucket padded on the host to its (S, B, L)/(S, B) device shape,
    B a multiple of ``data_axis``: (cols, vals, deg). Pad rows carry zero
    degree."""
    s, b = _slab_shape(bucket.row_ids.shape[0], bucket.pad_len, rank, data_axis,
                       max_slab_elems)
    return (_pad_rows(bucket.cols, s, b), _pad_rows(bucket.vals, s, b),
            _pad_rows(bucket.deg, s, b))


def pad_chunk_slab(slab: ChunkSlab, rank: int, max_slab_elems: int, data_axis: int = 1
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One chunk slab padded on the host to its (S, B, ...) device shape,
    B a multiple of ``data_axis``: (row_ids, cols, vals, deg). Pad chunks
    carry row 0 with zero degree, so they add nothing."""
    n, L = slab.cols.shape
    s, b = _slab_shape(n, L, rank, data_axis, max_slab_elems)
    return (_pad_rows(slab.row_ids, s, b), _pad_rows(slab.cols, s, b),
            _pad_rows(slab.vals, s, b), _pad_rows(slab.deg, s, b))


def _to_device(a: np.ndarray, device: torch.device, pinned: bool = False) -> torch.Tensor:
    """``a`` on ``device``. ``pinned`` (streaming) copies through page-locked
    memory without waiting for the card, so the host pads the next bucket
    while the card solves this one; the caching host allocator holds the
    pinned buffer until its copy is done."""
    t = torch.from_numpy(a)
    if pinned and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _data_split(a: np.ndarray, mesh: Mesh) -> ShardedArray:
    """A padded (S, B, ...) host slab split over the mesh's "data" axis
    along B."""
    return device_put(a, NamedSharding(mesh, (None, "data")))


def _stage_bucket(bucket: Bucket, rank: int, max_slab_elems: int,
                  device: torch.device | None, pinned: bool = False,
                  mesh: Mesh | None = None) -> DeviceBucket:
    if mesh is not None:
        cols, vals, deg = pad_bucket_slabs(bucket, rank, max_slab_elems,
                                           mesh.axis_size("data"))
        ids = np.full(deg.size, -1, dtype=np.int64)
        ids[: bucket.row_ids.shape[0]] = bucket.row_ids
        return DeviceBucket(row_ids=_data_split(ids.reshape(deg.shape), mesh),
                            cols=_data_split(cols, mesh), vals=_data_split(vals, mesh),
                            deg=_data_split(deg, mesh), n=int(bucket.row_ids.shape[0]),
                            pad_len=bucket.pad_len)
    cols, vals, deg = pad_bucket_slabs(bucket, rank, max_slab_elems)
    return DeviceBucket(
        row_ids=_to_device(bucket.row_ids.astype(np.int64), device, pinned),
        cols=_to_device(cols, device, pinned), vals=_to_device(vals, device, pinned),
        deg=_to_device(deg, device, pinned),
        n=int(bucket.row_ids.shape[0]), pad_len=bucket.pad_len)


def stage_buckets(bucketed: BucketedRatings, rank: int,
                  max_slab_elems: int = _MAX_SLAB_ELEMS,
                  device: str | torch.device | None = None,
                  mesh: Mesh | None = None) -> DeviceBucketedRatings:
    """Every bucket resident on ``device`` (default ``cuda``), or split
    over ``mesh``'s "data" axis: about 8 bytes per padded rating. For a
    set that does not fit, keep the host :class:`BucketedRatings`:
    :func:`solve_half` then streams it."""
    dev = None if mesh is not None else resolve_device(device)
    return DeviceBucketedRatings(
        tuple(_stage_bucket(b, rank, max_slab_elems, dev, mesh=mesh)
              for b in bucketed.buckets),
        bucketed.num_rows, bucketed.num_cols, bucketed.nnz)


def stage_chunks(chunked: ChunkedRatings, rank: int, max_slab_elems: int = _MAX_SLAB_ELEMS,
                 device: str | torch.device | None = None,
                 mesh: Mesh | None = None) -> DeviceChunkedRatings:
    """Every chunk slab resident on ``device`` (default ``cuda``), or split
    over ``mesh``'s "data" axis."""
    out = []
    if mesh is not None:
        for slab in chunked.slabs:
            rids, cols, vals, deg = pad_chunk_slab(slab, rank, max_slab_elems,
                                                   mesh.axis_size("data"))
            out.append(DeviceChunkSlab(*(_data_split(a, mesh) for a in (
                rids.astype(np.int64), cols, vals, deg))))
        return DeviceChunkedRatings(tuple(out), chunked.num_rows, chunked.num_cols,
                                    chunked.nnz)
    dev = resolve_device(device)
    for slab in chunked.slabs:
        rids, cols, vals, deg = pad_chunk_slab(slab, rank, max_slab_elems)
        out.append(DeviceChunkSlab(_to_device(rids.astype(np.int64), dev),
                                   _to_device(cols, dev), _to_device(vals, dev),
                                   _to_device(deg, dev)))
    return DeviceChunkedRatings(tuple(out), chunked.num_rows, chunked.num_cols, chunked.nnz)


# ---------------------------------------------------------------------------
# Device code
# ---------------------------------------------------------------------------


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` with an f32 result. bf16 operands accumulate in
    f32 without rounding the result (JAX's preferred_element_type=f32):
    on the card through ``bmm(..., out_dtype=float32)``; on the CPU,
    which has no such kernel, the bf16 values multiply in f32, where
    their products are exact — the same function up to summation order.
    f32 operands multiply in f32 (callers hold ``ieee_f32``)."""
    if a.dtype == torch.bfloat16:
        if a.is_cuda:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())
    return torch.bmm(a, b)


def _cho_solve_batched(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD systems A x = b for (..., K, K) / (..., K) exactly: the
    ``solver="cholesky"`` option and the oracle CG is held against. A
    factorization that fails gives NaN, as in JAX, and is not checked on
    the host (which would wait for the device)."""
    chol, info = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(chol, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(chol.mT, y, upper=True)[..., 0]
    return torch.where((info == 0)[..., None], x, float("nan"))


def _cg_solve_batched(A: torch.Tensor, b: torch.Tensor, steps: int | None = None,
                      bf16_matvec: bool = False) -> torch.Tensor:
    """Solve SPD systems A x = b for (B, K, K) / (B, K) by batched
    conjugate gradients, ``steps`` fixed (default ``min(K + 4, 16)``).

    ``bf16_matvec`` streams A in bf16 through the matvec, f32
    accumulation; the vectors and scalars stay f32. A step whose
    ``p·Ap <= 0`` (rounding on a near-singular system) is a zero step,
    so the iterate stays finite. No value is read on the host."""
    if steps is None:
        steps = min(A.shape[-1] + 4, _CG_STEP_CAP)
    if bf16_matvec:
        A_mm = A.to(torch.bfloat16)
        if not A_mm.is_cuda:
            A_mm = A_mm.float()     # bf16-rounded A, multiplied in f32

        def matvec(p):
            pb = p.to(torch.bfloat16)
            if A_mm.is_cuda:
                return torch.bmm(A_mm, pb[..., None], out_dtype=torch.float32)[..., 0]
            return torch.bmm(A_mm, pb.float()[..., None])[..., 0]
    else:
        def matvec(p):
            return torch.bmm(A, p[..., None])[..., 0]

    x = torch.zeros_like(b)
    r = b
    p = r
    rs = (r * r).sum(-1)
    for _ in range(steps):
        Ap = matvec(p)
        denom = (p * Ap).sum(-1)
        pos = denom > 0
        alpha = torch.where(pos, rs / torch.where(pos, denom, 1.0), 0.0)[:, None]
        x = torch.addcmul(x, alpha, p)
        r = torch.addcmul(r, alpha, Ap, value=-1.0)
        rs_new = (r * r).sum(-1)
        beta = (rs_new / rs.clamp_min(1e-30))[:, None]
        p = torch.addcmul(r, beta, p)
        rs = rs_new
    return x


def _partial_normal_eq(V: torch.Tensor, c: torch.Tensor, v: torch.Tensor, d: torch.Tensor,
                       alpha: float, implicit: bool
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The unregularised normal-equation sums of B rows or row chunks:
    (A (B, K, K), b (B, K), mask (B, L)), f32. ``(c, v, d)`` are (B, L)
    cols/vals and (B,) degrees; ``V`` is the opposite factor table
    already in the build dtype (bf16 or f32)."""
    K = V.shape[1]
    L = c.shape[-1]
    mm = V.dtype
    m = (torch.arange(L, dtype=torch.int32, device=c.device)[None, :]
         < d[:, None]).float()
    F = torch.index_select(V, 0, c.reshape(-1)).view(c.shape[0], L, K)  # the row gather
    if implicit:
        # Hu-Koren with MLlib trainImplicit's rule: confidence 1 + α|r|,
        # preference [r > 0], so a negative rating is a confident zero
        # preference and r = 0 adds nothing: A = Σ (c-1) v vᵀ, b = Σ c p v.
        # The weight is rounded to the build dtype, the weighted rows are
        # not (the JAX einsum multiplies w·F in f32)
        w = (alpha * v.abs() * m).to(mm)
        Fw = w.float()[..., None] * F.float()
        A = torch.bmm(Fw.mT, F.float())
        bw = torch.where(v > 0, 1.0 + alpha * v, 0.0) * m
        b = _bmm_f32(bw.to(mm)[:, None, :], F)[:, 0, :]
    else:
        # ALS-WR: A = Σ v vᵀ ; b = Σ r v
        Fm = F * m[..., None].to(mm)
        A = _bmm_f32(Fm.mT, F)
        b = _bmm_f32((v * m).to(mm)[:, None, :], F)[:, 0, :]
    return A, b, m


def _normal_eq_build(V: torch.Tensor, c: torch.Tensor, v: torch.Tensor, d: torch.Tensor,
                     lam: float, alpha: float, gram: torch.Tensor | None,
                     implicit: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The normal equations (A (B, K, K), b (B, K), f32) of B complete
    rows: :func:`_partial_normal_eq` plus ``VᵀV + λI`` (implicit, ``gram``
    the f32 VᵀV) or ``λ n_u I`` (explicit). Rows of degree 0 get A = I."""
    A, b, m = _partial_normal_eq(V, c, v, d, alpha, implicit)
    eye = torch.eye(V.shape[1], dtype=torch.float32, device=V.device)
    if implicit:
        A = A + gram + lam * eye
    else:
        A = A + (lam * m.sum(1))[:, None, None] * eye
    return torch.where((d > 0)[:, None, None], A, eye), b   # empty rows: x = 0


def _normal_eq_solve(V: torch.Tensor, c: torch.Tensor, v: torch.Tensor, d: torch.Tensor,
                     lam: float, alpha: float, gram: torch.Tensor | None, implicit: bool,
                     cg_steps: int | None, solver: str = "cg",
                     cg_bf16: bool = False) -> torch.Tensor:
    """Build (:func:`_normal_eq_build`) and solve the normal equations of
    B complete rows: (B, K) f32 factors, zero for rows of degree 0."""
    A, b = _normal_eq_build(V, c, v, d, lam, alpha, gram, implicit)
    if solver == "cholesky":
        x = _cho_solve_batched(A, b)
    else:
        x = _cg_solve_batched(A, b, steps=cg_steps, bf16_matvec=cg_bf16)
    return torch.where((d > 0)[:, None], x, 0.0)


def _gramian(V: torch.Tensor) -> torch.Tensor:
    """VᵀV in true f32 (callers hold ``ieee_f32``)."""
    return V.T @ V


def _solve_slabs(Vm: torch.Tensor, bucket: DeviceBucket, lam: float, alpha: float,
                 gram: torch.Tensor | None, implicit: bool, cg_steps: int | None,
                 solver: str, cg_bf16: bool) -> torch.Tensor:
    """One bucket's rows solved slab by slab: (S, B, K) f32, zero for pad
    rows. ``Vm`` is the gather table in the build dtype."""
    X = torch.empty((*bucket.deg.shape, Vm.shape[1]), dtype=torch.float32, device=Vm.device)
    for s in range(bucket.cols.shape[0]):
        X[s] = _normal_eq_solve(Vm, bucket.cols[s], bucket.vals[s], bucket.deg[s], lam,
                                alpha, gram, implicit, cg_steps, solver, cg_bf16)
    return X


def _solve_half_buckets(V: torch.Tensor, buckets: BucketedRatings | DeviceBucketedRatings,
                        lam: float, alpha: float, implicit: bool, bf16: bool,
                        cg_steps: int | None, solver: str = "cg", cg_bf16: bool = False,
                        max_slab_elems: int = _MAX_SLAB_ELEMS) -> torch.Tensor:
    """One half-step over whole-row buckets (the ladder or the
    power-of-growth layout): per slab, build and solve the rows' normal
    equations; per bucket, write the rows back. Host buckets stream: each
    is staged for its solve and freed after it."""
    K = V.shape[1]
    with ieee_f32():
        gram = _gramian(V) if implicit else None
        Vm = V.to(torch.bfloat16) if bf16 else V   # the gather walks the narrow table
        out = torch.zeros((buckets.num_rows, K), dtype=torch.float32, device=V.device)
        for bucket in buckets.buckets:
            if isinstance(bucket, Bucket):
                bucket = _stage_bucket(bucket, K, max_slab_elems, V.device, pinned=True)
            X = _solve_slabs(Vm, bucket, lam, alpha, gram, implicit, cg_steps, solver, cg_bf16)
            out.index_copy_(0, bucket.row_ids, X.view(-1, K)[: bucket.n])
            del bucket, X   # a streamed bucket's slabs go before the next is staged
    return out


def _chunk_accumulate(Vm: torch.Tensor, slabs, n: int, alpha: float,
                      implicit: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each chunk's partial normal equations added per row (``index_add_``)
    into (n, K, K), (n, K) and (n,) accumulators. ``slabs`` are (row_ids,
    cols, vals, deg) slab tensors."""
    K = Vm.shape[1]
    dev = Vm.device
    A = torch.zeros((n, K, K), dtype=torch.float32, device=dev)
    b = torch.zeros((n, K), dtype=torch.float32, device=dev)
    cnt = torch.zeros((n,), dtype=torch.float32, device=dev)
    for rids, cols, vals, deg in slabs:
        for s in range(cols.shape[0]):
            A_s, b_s, m = _partial_normal_eq(Vm, cols[s], vals[s], deg[s], alpha, implicit)
            r = rids[s]
            A.index_add_(0, r, A_s)
            b.index_add_(0, r, b_s)
            cnt.index_add_(0, r, m.sum(1))
    return A, b, cnt


def _chunk_solve(A: torch.Tensor, b: torch.Tensor, cnt: torch.Tensor, V: torch.Tensor,
                 lam: float, implicit: bool, cg_steps: int | None,
                 cg_bf16: bool) -> torch.Tensor:
    """The ridge (``λ·n`` or ``VᵀV + λI``, in place: off the diagonal it
    adds zeros), the identity for unrated rows, and one batched CG over
    every row; unrated rows come out zero."""
    if implicit:
        A += _gramian(V)
        A.diagonal(dim1=-2, dim2=-1).add_(lam)
    else:
        A.diagonal(dim1=-2, dim2=-1).add_((lam * cnt)[:, None])
    active = cnt > 0
    eye = torch.eye(A.shape[-1], dtype=torch.float32, device=A.device)
    torch.where(active[:, None, None], A, eye, out=A)
    x = _cg_solve_batched(A, b, steps=cg_steps, bf16_matvec=cg_bf16)
    return torch.where(active[:, None], x, 0.0)


def _solve_half_chunked(V: torch.Tensor, chunked: DeviceChunkedRatings, lam: float,
                        alpha: float, implicit: bool, bf16: bool, cg_steps: int | None,
                        cg_bf16: bool = False) -> torch.Tensor:
    """One half-step over the chunked layout: each chunk's partial normal
    equations are added per row into (num_rows, K, K), (num_rows, K) and
    (num_rows,) accumulators (``index_add_``: the order of the additions
    may vary from run to run on the card); then the ridge, the identity
    for unrated rows, and one batched CG over every row. Unrated rows
    come out zero."""
    with ieee_f32():
        Vm = V.to(torch.bfloat16) if bf16 else V
        A, b, cnt = _chunk_accumulate(
            Vm, [(sl.row_ids, sl.cols, sl.vals, sl.deg) for sl in chunked.slabs],
            chunked.num_rows, alpha, implicit)
        return _chunk_solve(A, b, cnt, V, lam, implicit, cg_steps, cg_bf16)


def _als_iterate_fused(item0: torch.Tensor, user_buckets: DeviceBucketedRatings,
                       item_buckets: DeviceBucketedRatings, iterations: int, lam: float,
                       alpha: float, implicit: bool, bf16: bool = False,
                       cg_steps: int | None = None, solver: str = "cg",
                       cg_bf16: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``iterations`` alternating half-steps from ``item0``, users first."""
    user = torch.zeros((user_buckets.num_rows, item0.shape[1]), dtype=torch.float32,
                       device=item0.device)
    item = item0
    for _ in range(iterations):
        user = _solve_half_buckets(item, user_buckets, lam, alpha, implicit, bf16,
                                   cg_steps, solver, cg_bf16)
        item = _solve_half_buckets(user, item_buckets, lam, alpha, implicit, bf16,
                                   cg_steps, solver, cg_bf16)
    return user, item


# ---------------------------------------------------------------------------
# Over a device mesh: the JAX package's shard_map bodies, position by position
# ---------------------------------------------------------------------------


def _gather_table(V: torch.Tensor | ShardedArray, mesh: Mesh) -> ShardedArray:
    """The opposite factor table whole at every position: the tiled
    all-gather over "model" of a row-sharded table (once per half-step),
    or a replicated copy of an unsharded one."""
    if isinstance(V, ShardedArray):
        return all_gather(V, "model") if V.spec[0] == "model" else V
    return device_put(V, replicated(mesh))


def _row_shard(V: torch.Tensor, mesh: Mesh) -> ShardedArray:
    """``V`` zero-padded to the "model" axis multiple and row-sharded over
    it (pad rows are never gathered: column ids stay below the real row
    count; they add nothing to VᵀV)."""
    pad = (-V.shape[0]) % mesh.axis_size("model")
    if pad:
        V = torch.cat([V, V.new_zeros((pad, V.shape[1]))])
    return device_put(V, model_sharding(mesh))


def _local_tables(V_all: ShardedArray, bf16: bool, implicit: bool):
    """Per position, (gather table in the build dtype, f32 VᵀV or None),
    made once for each distinct local table."""
    made: dict[int, tuple] = {}

    def at(pos):
        V_l = V_all.local(pos)
        if id(V_l) not in made:
            made[id(V_l)] = (V_l.to(torch.bfloat16) if bf16 else V_l,
                             _gramian(V_l) if implicit else None)
        return made[id(V_l)]

    return at


def _per_data_shard(mesh: Mesh, solve) -> dict:
    """``solve(pos)``, the local phase of a function replicated over
    "model" (its inputs are split over "data" only), at every position;
    computed once for each (device, data index): the positions of one
    device along "model" share it."""
    made: dict = {}
    out = {}
    for pos in mesh.positions:
        key = (mesh.device(pos), axis_index(mesh, pos, "data"))
        if key not in made:
            made[key] = solve(pos)
        out[pos] = made[key]
    return out


def _write_rows(parts: dict, mesh: Mesh, num_rows: int, K: int,
                sharded: bool) -> torch.Tensor | ShardedArray:
    """The write-back collective. ``parts`` maps each position to the rows
    it solved, as (row ids, rows) pairs (id -1: a pad row); every data
    shard's rows are solved at each position along "model". ``sharded``:
    a (num_rows, K) table row-sharded over "model" (it must divide the
    axis), where the shard of model index m takes the rows it owns from
    the positions of that index, one per data shard (a local scatter,
    then the combine over "data"), built once on each device that holds
    it; else the whole table on the mesh's first device, from the
    positions of model index 0. Each target keeps one extra row where pad
    rows and rows it does not own land, cut off after."""
    def build(dev, m, lo, n):
        buf = torch.zeros((n + 1, K), dtype=torch.float32, device=dev)
        for pos in mesh.positions:
            if axis_index(mesh, pos, "model") != m:
                continue
            for ids, X in parts.get(pos, ()):
                ids = ids.to(dev)
                loc = ids - lo
                buf.index_copy_(0, torch.where((ids >= 0) & (loc >= 0) & (loc < n), loc, n),
                                X.to(dev))
        return buf[:n]

    if not sharded:
        return build(mesh.device(mesh.positions[0]), 0, 0, num_rows)
    n_loc = num_rows // mesh.axis_size("model")
    return ShardedArray(mesh, ("model", None), per_device(
        mesh, lambda pos: build(mesh.device(pos), axis_index(mesh, pos, "model"),
                                axis_index(mesh, pos, "model") * n_loc, n_loc),
        lambda pos: axis_index(mesh, pos, "model")))


def _solve_half_buckets_mesh(V: torch.Tensor | ShardedArray,
                             buckets: BucketedRatings | DeviceBucketedRatings, mesh: Mesh,
                             lam: float, alpha: float, implicit: bool, bf16: bool,
                             cg_steps: int | None, solver: str, cg_bf16: bool,
                             max_slab_elems: int, num_rows: int,
                             sharded: bool) -> torch.Tensor | ShardedArray:
    """One whole-row half-step over ``mesh``, JAX's shard_map body: the
    opposite table gathered whole at every position (the all-gather over
    "model"); each position builds and solves, slab by slab, the rows of
    its data shard, on its device (replicated over "model":
    :func:`_per_data_shard`); then :func:`_write_rows`. Host buckets
    stream, each staged over the mesh for its solve."""
    K = V.shape[1]
    parts: dict = {}
    with ieee_f32():
        tables = _local_tables(_gather_table(V, mesh), bf16, implicit)
        for bucket in buckets.buckets:
            if isinstance(bucket, Bucket):
                bucket = _stage_bucket(bucket, K, max_slab_elems, None, pinned=True, mesh=mesh)

            def solve(pos, bucket=bucket):
                Vm, gram = tables(pos)
                cols, vals, deg = (x.local(pos) for x in (bucket.cols, bucket.vals, bucket.deg))
                X = torch.empty((*deg.shape, K), dtype=torch.float32, device=cols.device)
                for s in range(cols.shape[0]):
                    X[s] = _normal_eq_solve(Vm, cols[s], vals[s], deg[s], lam, alpha, gram,
                                            implicit, cg_steps, solver, cg_bf16)
                return bucket.row_ids.local(pos).reshape(-1), X.view(-1, K)

            for pos, part_ in _per_data_shard(mesh, solve).items():
                parts.setdefault(pos, []).append(part_)
    return _write_rows(parts, mesh, num_rows, K, sharded)


def _solve_half_chunked_mesh(V: torch.Tensor | ShardedArray, chunked: DeviceChunkedRatings,
                             mesh: Mesh, lam: float, alpha: float, implicit: bool, bf16: bool,
                             cg_steps: int | None, cg_bf16: bool) -> torch.Tensor:
    """One chunked half-step over ``mesh``: each position accumulates the
    chunks of its data shard (replicated over "model":
    :func:`_per_data_shard`); the accumulators are summed over "data"
    (``psum``, once per device); the solve runs on the mesh's first
    device, where the (replicated) result is kept."""
    V_all = _gather_table(V, mesh)
    with ieee_f32():
        tables = _local_tables(V_all, bf16, False)
        acc = _per_data_shard(mesh, lambda pos: _chunk_accumulate(
            tables(pos)[0], [tuple(x.local(pos) for x in (sl.row_ids, sl.cols, sl.vals, sl.deg))
                             for sl in chunked.slabs], chunked.num_rows, alpha, implicit))
        summed = [psum(ShardedArray.from_local(mesh, (), lambda pos: acc[pos][i]), "data")
                  for i in range(3)]
        del acc
        home = mesh.positions[0]
        return _chunk_solve(*(x.local(home) for x in summed), V_all.local(home), lam,
                            implicit, cg_steps, cg_bf16)


def _als_iterate_mesh(item0: torch.Tensor, user_buckets: DeviceBucketedRatings,
                      item_buckets: DeviceBucketedRatings, iterations: int, lam: float,
                      alpha: float, implicit: bool, bf16: bool, cg_steps: int | None,
                      solver: str, cg_bf16: bool, mesh: Mesh, shard_factors: bool,
                      num_users: int, num_items: int):
    """``iterations`` alternating whole-row half-steps over ``mesh`` from
    ``item0``, users first. ``shard_factors``: both tables stay row-sharded
    over "model" between half-steps (``num_users``/``num_items``, padded
    by the caller, divide it); else both are kept whole on the mesh's
    first device."""
    K = item0.shape[1]
    item = _row_shard(item0, mesh) if shard_factors else item0.to(mesh.device(mesh.positions[0]))
    user = _write_rows({}, mesh, num_users, K, shard_factors)
    for _ in range(iterations):
        user = _solve_half_buckets_mesh(item, user_buckets, mesh, lam, alpha, implicit, bf16,
                                        cg_steps, solver, cg_bf16, _MAX_SLAB_ELEMS, num_users,
                                        shard_factors)
        item = _solve_half_buckets_mesh(user, item_buckets, mesh, lam, alpha, implicit, bf16,
                                        cg_steps, solver, cg_bf16, _MAX_SLAB_ELEMS, num_items,
                                        shard_factors)
    return user, item


def _staged_over(layout, mesh: Mesh | None) -> None:
    """Device layouts must be staged over the mesh they are solved on."""
    parts = getattr(layout, "buckets", None) or getattr(layout, "slabs", None) or ()
    for x in parts:
        cols = getattr(x, "cols", None)
        if isinstance(cols, np.ndarray):
            return   # a host layout, staged per call
        got = cols.mesh if isinstance(cols, ShardedArray) else None
        if got is not mesh:
            raise ValueError("the layout was staged over another mesh than the one it is "
                             "solved on (stage it with the same mesh=, or none)")


#: rank at or above which the "auto" CG matvec streams A in bf16
_CG_BF16_RANK = 64


def _resolve_cg_matvec(cg_matvec_dtype: str, rank: int) -> bool:
    if cg_matvec_dtype not in ("auto", "float32", "bfloat16"):
        raise ValueError(
            "cg_matvec_dtype must be 'auto', 'float32' or 'bfloat16', "
            f"got {cg_matvec_dtype!r}")
    if cg_matvec_dtype == "auto":
        return rank >= _CG_BF16_RANK
    return cg_matvec_dtype == "bfloat16"


def _check_matmul_dtype(matmul_dtype: str) -> bool:
    if matmul_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"matmul_dtype must be 'float32' or 'bfloat16', got {matmul_dtype!r}")
    return matmul_dtype == "bfloat16"


def _check_solver(solver: str) -> None:
    if solver not in ("cg", "cholesky"):
        raise ValueError(f"solver must be 'cg' or 'cholesky', got {solver!r}")


_CHUNKED_CHOLESKY = ("solver='cholesky' is a bucketed/fused-layout option; the "
                     "chunked path solves over the scan-carried accumulator")


def solve_half(V: torch.Tensor | ShardedArray,
               bucketed: BucketedRatings | DeviceBucketedRatings | ChunkedRatings
               | DeviceChunkedRatings,
               rank: int, lam: float, implicit: bool = False, alpha: float = 40.0,
               max_slab_elems: int = _MAX_SLAB_ELEMS, matmul_dtype: str = "float32",
               shard_factors: bool = False, cg_steps: int | None = None,
               solver: str = "cg", cg_matvec_dtype: str = "float32",
               mesh: Mesh | None = None) -> torch.Tensor:
    """One half-step: all row factors of ``bucketed`` given the opposite
    factors ``V`` (on the device the rows are solved on). Returns a
    (num_rows, K) f32 table, zero for rows with no ratings.

    Whole-row buckets are solved bucket by bucket; chunked layouts
    (:func:`chunk_rows`, :func:`stage_chunks`) accumulate per row, then
    solve once (CG only). Host :class:`BucketedRatings` stream: one
    bucket on the device at a time, freed after its solve, so device
    memory stays bounded by the largest bucket's slabs. A host
    :class:`ChunkedRatings` is staged whole for this call. Pass the
    staged layouts when calling repeatedly.

    With a ``mesh`` the rows are solved over its positions (layouts staged
    over the same mesh), and the table comes back whole on its first
    device. ``shard_factors=True`` with a "model" axis > 1 row-shards the
    opposite table ``V`` over that axis (each position gathers it whole
    for its slab gathers); without a mesh it has no effect."""
    bf16 = _check_matmul_dtype(matmul_dtype)
    _check_solver(solver)
    cg_bf16 = _resolve_cg_matvec(cg_matvec_dtype, rank)
    chunked = isinstance(bucketed, (ChunkedRatings, DeviceChunkedRatings))
    if chunked and solver != "cg":
        raise ValueError(_CHUNKED_CHOLESKY)
    _staged_over(bucketed, mesh)
    if mesh is not None:
        if isinstance(V, ShardedArray) and not (shard_factors and V.spec[0] == "model"
                                                and V.dtype == torch.float32):
            V = V.gather()
        if not isinstance(V, ShardedArray):
            V = V.float()
            if shard_factors and mesh.axis_size("model") > 1:
                V = _row_shard(V, mesh)
        if chunked:
            if isinstance(bucketed, ChunkedRatings):
                bucketed = stage_chunks(bucketed, rank, max_slab_elems, mesh=mesh)
            return _solve_half_chunked_mesh(V, bucketed, mesh, float(lam), float(alpha),
                                            implicit, bf16, cg_steps, cg_bf16)
        return _solve_half_buckets_mesh(V, bucketed, mesh, float(lam), float(alpha), implicit,
                                        bf16, cg_steps, solver, cg_bf16, max_slab_elems,
                                        bucketed.num_rows, False)
    V = (V.gather() if isinstance(V, ShardedArray) else V).float()
    if chunked:
        if isinstance(bucketed, ChunkedRatings):
            bucketed = stage_chunks(bucketed, rank, max_slab_elems, device=V.device)
        return _solve_half_chunked(V, bucketed, float(lam), float(alpha), implicit, bf16,
                                   cg_steps, cg_bf16)
    return _solve_half_buckets(V, bucketed, float(lam), float(alpha), implicit, bf16,
                               cg_steps, solver, cg_bf16, max_slab_elems)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ALSFactors:
    """The trained tables: tensors, or row-sharded over a mesh's "model"
    axis when trained with ``shard_factors``."""

    user: torch.Tensor | ShardedArray  # (num_users, K)
    item: torch.Tensor | ShardedArray  # (num_items, K)


def resolve_shard_factors(param: bool) -> bool:
    """The engine-params ``shardFactors`` knob with its fleet-wide env
    override: ``PIO_TRAIN_SHARD_FACTORS=1`` forces it on, ``=0`` off,
    unset defers to the param."""
    raw = os.environ.get("PIO_TRAIN_SHARD_FACTORS", "").strip().lower()
    if raw in ("1", "true", "on", "yes"):
        return True
    if raw in ("0", "false", "off", "no"):
        return False
    return bool(param)


def init_item_factors(num_items: int, rank: int, seed: int) -> torch.Tensor:
    """The port's initial item factors: standard normals from a CPU
    ``torch.Generator`` seeded with ``seed``, scaled by 1/sqrt(rank) —
    the same on every device (JAX's PRNGKey draw cannot be reproduced;
    ``als_train`` takes an explicit ``item0`` instead)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((num_items, rank), generator=gen, dtype=torch.float32) / math.sqrt(rank)


def als_train(ratings: RatingsCOO, rank: int, iterations: int = 10, lam: float = 0.01,
              implicit: bool = False, alpha: float = 40.0, seed: int = 0,
              min_bucket: int = 8, bucket_growth: int = 2, max_row_len: int | None = None,
              max_slab_elems: int = _MAX_SLAB_ELEMS, hbm_resident: bool = True,
              matmul_dtype: str = "bfloat16", layout: str = "auto",
              chunk_sizes: Sequence[int] = (512, 128), chunked_acc_budget: int = 4 << 30,
              cg_steps: int | None = None, solver: str = "cg", shard_factors: bool = False,
              cg_matvec_dtype: str = "auto", item0: np.ndarray | torch.Tensor | None = None,
              device: str | torch.device | None = None,
              mesh: Mesh | None = None) -> ALSFactors:
    """Full alternating-least-squares training on ``device`` (default
    ``cuda``), or over ``mesh``'s devices, with the semantics of MLlib
    ``ALS.train`` / ``ALS.trainImplicit``; the JAX package's arguments
    and defaults.

    ``layout="fused"`` pads whole rows to the ladder (:func:`ladder_rows`)
    and solves each slab's rows where it builds them. ``"bucketed"`` pads
    whole rows to powers of ``bucket_growth`` from ``min_bucket``
    (:func:`bucket_rows`): the only layout with ``max_row_len`` (a row
    keeps its top-valued ratings) and ``hbm_resident=False`` (the slabs
    stay on the host and stream, one bucket at a time, every half-step).
    ``"chunked"`` cuts rows into ``chunk_sizes`` chunks (:func:`chunk_rows`)
    and accumulates per row before one solve. ``"auto"`` picks bucketed
    when ``max_row_len`` is set or ``hbm_resident`` is False, else fused.
    ``chunked_acc_budget`` is accepted and unused, as in the JAX package.

    ``matmul_dtype="bfloat16"`` (default) builds the normal equations
    from bf16 operands with f32 accumulation; "float32" in true f32.
    ``cg_matvec_dtype="auto"`` streams the CG matrix in bf16 at rank >=
    64. ``solver="cholesky"`` solves exactly (not on the chunked layout).
    ``item0`` is the (num_items, rank) starting table; without it
    :func:`init_item_factors` draws one from ``seed``.

    With a ``mesh`` the slabs split over its "data" axis and every
    position solves its own rows (the module docstring); the tables come
    back whole on the mesh's first device. ``shard_factors=True`` with a
    "model" axis > 1 keeps both tables row-sharded over it: on the fused
    layout for the whole run (padded to the axis multiple, the padding
    trimmed from the result, which comes back sharded: :class:`ShardedArray`),
    on the others for the opposite table of each half-step, as in the
    JAX package. Without a mesh ``shard_factors`` has no effect."""
    if layout not in ("auto", "fused", "chunked", "bucketed"):
        raise ValueError(f"layout must be 'auto', 'fused', 'chunked' or 'bucketed', "
                         f"got {layout!r}")
    bucketed_knobs = max_row_len is not None or not hbm_resident
    if layout == "auto":
        layout = "bucketed" if bucketed_knobs else "fused"
    if layout == "fused" and bucketed_knobs:
        raise ValueError("max_row_len / hbm_resident=False are bucketed-layout knobs; "
                         "pass layout='bucketed' (or 'auto') to use them")
    if layout == "chunked" and bucketed_knobs:
        raise ValueError(
            "max_row_len / hbm_resident=False are bucketed-layout knobs "
            "(row capping and streaming); pass layout='bucketed' (or "
            "'auto') to use them — the chunked layout never drops ratings "
            "and stages slabs HBM-resident")
    bf16 = _check_matmul_dtype(matmul_dtype)
    _check_solver(solver)
    if layout == "chunked" and solver != "cg":
        raise ValueError(_CHUNKED_CHOLESKY)
    cg_bf16 = _resolve_cg_matvec(cg_matvec_dtype, rank)
    dev = resolve_device(device) if mesh is None else mesh.device(mesh.positions[0])
    tp = bool(shard_factors and mesh is not None and mesh.axis_size("model") > 1)
    if item0 is None:
        item0 = init_item_factors(ratings.num_cols, rank, seed)
    if isinstance(item0, np.ndarray):
        item0 = torch.from_numpy(np.array(item0, dtype=np.float32))
    item0 = item0.float()
    if tuple(item0.shape) != (ratings.num_cols, rank):
        raise ValueError(f"item0 has shape {tuple(item0.shape)}, expected "
                         f"({ratings.num_cols}, {rank})")
    if layout == "fused":
        by_user = ladder_rows(ratings)
        by_item = ladder_rows(ratings.transpose())
        logger.info("ALS(fused): %d ratings, %d users (%d buckets), %d items (%d buckets), "
                    "rank %d, on %s", ratings.nnz, ratings.num_rows, len(by_user.buckets),
                    ratings.num_cols, len(by_item.buckets), rank, dev)
        if mesh is not None:
            return _als_train_fused_mesh(ratings, by_user, by_item, item0, iterations, lam,
                                         alpha, implicit, bf16, cg_steps, solver, cg_bf16,
                                         max_slab_elems, mesh, tp)
        dev_user = stage_buckets(by_user, rank, max_slab_elems, device=dev)
        dev_item = stage_buckets(by_item, rank, max_slab_elems, device=dev)
        user, item = _als_iterate_fused(item0.to(dev), dev_user, dev_item, iterations,
                                        float(lam), float(alpha), implicit, bf16, cg_steps,
                                        solver, cg_bf16)
        return ALSFactors(user=user, item=item)
    if layout == "chunked":
        by_user = chunk_rows(ratings, chunk_sizes)
        by_item = chunk_rows(ratings.transpose(), chunk_sizes)
        logger.info("ALS(chunked): %d ratings, %d users, %d items, rank %d, chunks %s, on %s",
                    ratings.nnz, ratings.num_rows, ratings.num_cols, rank,
                    tuple(s.cols.shape for s in by_user.slabs), dev)
        by_user = stage_chunks(by_user, rank, max_slab_elems, device=dev, mesh=mesh)
        by_item = stage_chunks(by_item, rank, max_slab_elems, device=dev, mesh=mesh)
    else:
        by_user = bucket_rows(ratings, min_bucket, bucket_growth, max_row_len)
        by_item = bucket_rows(ratings.transpose(), min_bucket, bucket_growth, max_row_len)
        logger.info("ALS(bucketed): %d ratings, %d users (%d buckets), %d items (%d buckets), "
                    "rank %d, %s, on %s", ratings.nnz, ratings.num_rows,
                    len(by_user.buckets), ratings.num_cols, len(by_item.buckets), rank,
                    "resident" if hbm_resident else "streamed", dev)
        if hbm_resident:
            by_user = stage_buckets(by_user, rank, max_slab_elems, device=dev, mesh=mesh)
            by_item = stage_buckets(by_item, rank, max_slab_elems, device=dev, mesh=mesh)
    kw = dict(implicit=implicit, alpha=alpha, max_slab_elems=max_slab_elems,
              matmul_dtype=matmul_dtype, cg_steps=cg_steps, solver=solver,
              cg_matvec_dtype=cg_matvec_dtype, shard_factors=shard_factors, mesh=mesh)
    user = torch.zeros((ratings.num_rows, rank), dtype=torch.float32, device=dev)
    item = item0.to(dev)
    for _ in range(iterations):
        user = solve_half(item, by_user, rank, lam, **kw)
        item = solve_half(user, by_item, rank, lam, **kw)
    return ALSFactors(user=user, item=item)


def _als_train_fused_mesh(ratings: RatingsCOO, by_user: BucketedRatings,
                          by_item: BucketedRatings, item0: torch.Tensor, iterations: int,
                          lam: float, alpha: float, implicit: bool, bf16: bool,
                          cg_steps: int | None, solver: str, cg_bf16: bool,
                          max_slab_elems: int, mesh: Mesh, tp: bool) -> ALSFactors:
    """The fused layout over ``mesh``: ladder slabs staged over its "data"
    axis; with ``tp`` the tables padded to the "model" axis multiple, so
    that every shard holds as many rows (pad rows are never gathered:
    column ids stay below the real row count), and the padding trimmed
    from the sharded result."""
    rank = item0.shape[1]
    logger.info("ALS(fused) over %s: %d ratings, %d users, %d items, rank %d, factors %s",
                mesh, ratings.nnz, ratings.num_rows, ratings.num_cols, rank,
                "row-sharded over 'model'" if tp else "whole")
    dev_user = stage_buckets(by_user, rank, max_slab_elems, mesh=mesh)
    dev_item = stage_buckets(by_item, rank, max_slab_elems, mesh=mesh)
    ways = mesh.axis_size("model") if tp else 1
    num_users_p = ratings.num_rows + (-ratings.num_rows) % ways
    num_items_p = ratings.num_cols + (-ratings.num_cols) % ways
    if num_items_p != ratings.num_cols:
        item0 = torch.cat([item0, item0.new_zeros((num_items_p - ratings.num_cols, rank))])
    user, item = _als_iterate_mesh(item0, dev_user, dev_item, iterations, float(lam),
                                   float(alpha), implicit, bf16, cg_steps, solver, cg_bf16,
                                   mesh, tp, num_users_p, num_items_p)
    if tp:
        user, item = user.head(ratings.num_rows), item.head(ratings.num_cols)
    return ALSFactors(user=user, item=item)


# ---------------------------------------------------------------------------
# Prediction helpers
# ---------------------------------------------------------------------------


def predict_ratings(user_f: torch.Tensor | ShardedArray, item_f: torch.Tensor | ShardedArray,
                    users, items) -> torch.Tensor:
    """Pointwise predicted ratings for (user, item) index pairs (the rows
    of a sharded table gathered from the shards that own them)."""
    users = torch.as_tensor(users, device=user_f.device).long()
    items = torch.as_tensor(items, device=item_f.device).long()
    with ieee_f32():
        return (user_f[users] * item_f[items].to(user_f.device)).sum(-1)


def rmse(factors: ALSFactors, ratings: RatingsCOO, chunk: int = 1 << 20) -> float:
    """Root-mean-square error over the rating set, in chunks: each
    chunk's f32 sum of squares on the device, the sums read once and
    added on the host in a Python float, as the JAX package adds them."""
    parts = []
    for s in range(0, ratings.nnz, chunk):
        e = min(s + chunk, ratings.nnz)
        pred = predict_ratings(factors.user, factors.item, ratings.rows[s:e],
                               ratings.cols[s:e])
        err = pred - torch.from_numpy(ratings.vals[s:e]).to(pred.device)
        parts.append((err * err).sum())
    total = sum(torch.stack(parts).tolist()) if parts else 0.0
    return math.sqrt(total / max(ratings.nnz, 1))
