"""Alternating least squares on one card (port of the JAX package's
``ops/als.py``, fused-ladder layout).

Explicit ratings train ALS-WR (``λ·n_u`` on the diagonal), implicit
feedback trains Hu-Koren-Volinsky with MLlib ``trainImplicit``'s
negative-rating rule, as MLlib's ``ALS.train``/``ALS.trainImplicit`` do
in the reference templates.

Layout: every row's ratings land in ONE bucket padded to the ladder
``LADDER_COUNTS × 128`` (or ``small`` for light rows), built on the host
by :func:`ladder_rows` and staged on the device once as ``(S, B, L)``
slabs (:func:`stage_buckets`), with the slab shapes of the JAX package.
A half-step gathers ``F = V[cols]`` per slab, builds the per-row normal
equations with batched products (bf16 operands accumulate in f32),
solves them with batched conjugate gradients (:func:`_cg_solve_batched`)
or Cholesky, and writes the rows back with ``index_copy_``. Where XLA
runs the whole training as one program, the port runs an eager Python
loop over iterations, buckets and slabs on tensors already on the
device; the loop never reads a device value on the host.

The host layout packs in C++ (``native/bucketize.cc`` ``pio_ladder``,
built with g++ at first use), with the NumPy path as the fallback and
the oracle. The JAX package's chunked and bucketed layouts and its mesh
sharding are not ported (ROADMAP.md queue 1 items 16 and 15).
"""

from __future__ import annotations

import ctypes
import dataclasses
import logging
import math
import os

import numpy as np
import torch

from predictionio_tpu_torch import native
from predictionio_tpu_torch.utils.device import ieee_f32, resolve_device

logger = logging.getLogger(__name__)

#: layouts packed by the native ``pio_ladder`` in this process (the
#: NumPy path counts none): ``chip_smoke.py`` reads it to show that the
#: native packer served
NATIVE_LADDERS = 0


# ---------------------------------------------------------------------------
# Host layout: COO ratings -> whole-row ladder buckets
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


#: pad-length ladder for :func:`ladder_rows`, in units of 128-entry
#: chunks; count padding is bounded by the gap ratio (<= 1.5x)
LADDER_COUNTS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128,
                 192, 256, 384, 512, 768, 1024, 1536, 2048)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _ladder_rows_native(coo: RatingsCOO, width: int, small: int) -> BucketedRatings | None:
    """The C++ packing path (``native/bucketize.cc`` ``pio_ladder``: one
    counting sort and one fill, behind the ``pio_bucketize_*`` handle
    calls); None when the library cannot be built or refuses the input."""
    global NATIVE_LADDERS
    lib = native.load_bucketize()
    if lib is None or coo.nnz == 0:
        return None
    i32, f32 = ctypes.c_int32, ctypes.c_float
    # the inputs stay referenced while the handle lives
    rows = np.ascontiguousarray(coo.rows, dtype=np.int32)
    cols = np.ascontiguousarray(coo.cols, dtype=np.int32)
    vals = np.ascontiguousarray(coo.vals, dtype=np.float32)
    ladder = np.ascontiguousarray(LADDER_COUNTS, dtype=np.int64)
    handle = lib.pio_ladder(coo.nnz, _ptr(rows, i32), _ptr(cols, i32), _ptr(vals, f32),
                            coo.num_rows, width, small, _ptr(ladder, ctypes.c_int64),
                            len(ladder))
    if not handle:
        return None
    try:
        buckets = []
        for b in range(lib.pio_bucketize_num_buckets(handle)):
            pad_len, n = ctypes.c_int32(), ctypes.c_int64()
            if lib.pio_bucketize_bucket_info(handle, b, ctypes.byref(pad_len), ctypes.byref(n)):
                return None
            pl, nn = int(pad_len.value), int(n.value)
            bucket = Bucket(np.empty((nn,), dtype=np.int32), np.empty((nn, pl), dtype=np.int32),
                            np.empty((nn, pl), dtype=np.float32), np.empty((nn,), dtype=np.int32))
            if lib.pio_bucketize_fill(handle, b, _ptr(bucket.row_ids, i32),
                                      _ptr(bucket.cols, i32), _ptr(bucket.vals, f32),
                                      _ptr(bucket.deg, i32)):
                return None
            buckets.append(bucket)
    finally:
        lib.pio_bucketize_free(handle)
    NATIVE_LADDERS += 1
    return BucketedRatings(tuple(buckets), coo.num_rows, coo.num_cols, coo.nnz)


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
    JAX mesh's; 1 on one card) with slab_rows*pad_len*rank <=
    max_slab_elems and slab_rows*rank^2 <= _MAX_SOLVE_ELEMS."""
    b = max(1, max_slab_elems // (pad_len * rank))
    b = min(b, max(1, _MAX_SOLVE_ELEMS // (rank * rank)))
    b = max(data_axis, (b // data_axis) * data_axis)
    b = min(b, ((n + data_axis - 1) // data_axis) * data_axis)
    return (n + b - 1) // b, b


def half_step_flops(bucketed: BucketedRatings, rank: int,
                    max_slab_elems: int = _MAX_SLAB_ELEMS, cg_steps: int | None = None,
                    solver: str = "cg") -> dict[str, float]:
    """Useful vs executed FLOPs of one half-step on this layout. Useful:
    ``2K² + 2K`` per real rating and the Cholesky minimum ``K³/3 + 2K²``
    per row. Executed: every padded slab entry, and the solve as the
    solver runs it (CG: ``steps × (2K² + 8K)``)."""
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
    for b in bucketed.buckets:
        n = int(b.row_ids.shape[0])
        useful += float(b.deg.sum()) * per_entry + n * per_solve
        s, rows = _slab_shape(n, b.pad_len, rank, 1, max_slab_elems)
        executed += float(s * rows) * (b.pad_len * per_entry + per_solve_exec)
    return {"useful_flops": useful, "executed_flops": executed}


# ---------------------------------------------------------------------------
# Device staging: pad buckets into slabs once, keep them resident
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceBucket:
    """One bucket on the device as (S, B, L) slabs; pad rows have degree 0."""

    row_ids: torch.Tensor  # int64 (n,)
    cols: torch.Tensor     # int32 (S, B, L)
    vals: torch.Tensor     # float32 (S, B, L), zero-padded
    deg: torch.Tensor      # int32 (S, B)
    n: int
    pad_len: int


@dataclasses.dataclass(frozen=True)
class DeviceBucketedRatings:
    """Ladder buckets resident on the device: build once with
    :func:`stage_buckets` and reuse across every iteration."""

    buckets: tuple[DeviceBucket, ...]
    num_rows: int
    num_cols: int
    nnz: int


def pad_bucket_slabs(bucket: Bucket, rank: int,
                     max_slab_elems: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One bucket padded on the host to its (S, B, L)/(S, B) device shape:
    (cols, vals, deg). Pad rows carry zero degree."""
    n = bucket.row_ids.shape[0]
    s, b = _slab_shape(n, bucket.pad_len, rank, 1, max_slab_elems)
    total = s * b

    def pad3(a):
        p = np.zeros((total, a.shape[1]), dtype=a.dtype)
        p[:n] = a
        return p.reshape(s, b, a.shape[1])

    deg = np.zeros((total,), dtype=np.int32)
    deg[:n] = bucket.deg
    return pad3(bucket.cols), pad3(bucket.vals), deg.reshape(s, b)


def _stage_bucket(bucket: Bucket, rank: int, max_slab_elems: int,
                  device: torch.device) -> DeviceBucket:
    cols, vals, deg = pad_bucket_slabs(bucket, rank, max_slab_elems)
    return DeviceBucket(
        row_ids=torch.from_numpy(bucket.row_ids.astype(np.int64)).to(device),
        cols=torch.from_numpy(cols).to(device),
        vals=torch.from_numpy(vals).to(device),
        deg=torch.from_numpy(deg).to(device),
        n=int(bucket.row_ids.shape[0]), pad_len=bucket.pad_len)


def stage_buckets(bucketed: BucketedRatings, rank: int,
                  max_slab_elems: int = _MAX_SLAB_ELEMS,
                  device: str | torch.device | None = None) -> DeviceBucketedRatings:
    """Every bucket resident on ``device`` (default ``cuda``): about 8
    bytes per padded rating."""
    dev = resolve_device(device)
    return DeviceBucketedRatings(
        tuple(_stage_bucket(b, rank, max_slab_elems, dev) for b in bucketed.buckets),
        bucketed.num_rows, bucketed.num_cols, bucketed.nnz)


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


def _normal_eq_build(V: torch.Tensor, c: torch.Tensor, v: torch.Tensor, d: torch.Tensor,
                     lam: float, alpha: float, gram: torch.Tensor | None,
                     implicit: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The normal equations (A (B, K, K), b (B, K), f32) of B complete
    rows. ``(c, v, d)`` are (B, L) cols/vals and (B,) degrees; ``V`` is
    the opposite factor table already in the build dtype (bf16 or f32),
    ``gram`` its f32 VᵀV (implicit only). Rows of degree 0 get A = I."""
    K = V.shape[1]
    L = c.shape[-1]
    mm = V.dtype
    eye = torch.eye(K, dtype=torch.float32, device=V.device)
    m = (torch.arange(L, dtype=torch.int32, device=c.device)[None, :]
         < d[:, None]).float()
    F = torch.index_select(V, 0, c.reshape(-1)).view(c.shape[0], L, K)  # the row gather
    if implicit:
        # Hu-Koren with MLlib trainImplicit's rule: confidence 1 + α|r|,
        # preference [r > 0], so a negative rating is a confident zero
        # preference and r = 0 adds nothing. A = VᵀV + Σ (c-1) v vᵀ + λI,
        # b = Σ c p v. The weight is rounded to the build dtype, the
        # weighted rows are not (the JAX einsum multiplies w·F in f32)
        w = (alpha * v.abs() * m).to(mm)
        Fw = w.float()[..., None] * F.float()
        A = torch.bmm(Fw.mT, F.float()) + gram + lam * eye
        bw = torch.where(v > 0, 1.0 + alpha * v, 0.0) * m
        b = _bmm_f32(bw.to(mm)[:, None, :], F)[:, 0, :]
    else:
        # ALS-WR: A = Σ v vᵀ + λ n_u I ; b = Σ r v
        Fm = F * m[..., None].to(mm)
        A = _bmm_f32(Fm.mT, F)
        n_u = m.sum(1)
        A = A + (lam * n_u)[:, None, None] * eye
        b = _bmm_f32((v * m).to(mm)[:, None, :], F)[:, 0, :]
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


def _solve_half_fused(V: torch.Tensor, buckets: DeviceBucketedRatings, lam: float,
                      alpha: float, implicit: bool, bf16: bool, cg_steps: int | None,
                      solver: str = "cg", cg_bf16: bool = False) -> torch.Tensor:
    """One half-step over the ladder layout: per slab, build and solve
    the rows' normal equations; per bucket, write the rows back."""
    K = V.shape[1]
    with ieee_f32():
        gram = V.T @ V if implicit else None
        Vm = V.to(torch.bfloat16) if bf16 else V   # the gather walks the narrow table
        out = torch.zeros((buckets.num_rows, K), dtype=torch.float32, device=V.device)
        for bucket in buckets.buckets:
            X = torch.empty((*bucket.deg.shape, K), dtype=torch.float32, device=V.device)
            for s in range(bucket.cols.shape[0]):
                X[s] = _normal_eq_solve(Vm, bucket.cols[s], bucket.vals[s], bucket.deg[s],
                                        lam, alpha, gram, implicit, cg_steps, solver, cg_bf16)
            out.index_copy_(0, bucket.row_ids, X.view(-1, K)[: bucket.n])
    return out


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
        user = _solve_half_fused(item, user_buckets, lam, alpha, implicit, bf16,
                                 cg_steps, solver, cg_bf16)
        item = _solve_half_fused(user, item_buckets, lam, alpha, implicit, bf16,
                                 cg_steps, solver, cg_bf16)
    return user, item


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


_SHARDED_ITEM = ("shard_factors=True (DP×MP factor sharding) needs several cards: "
                 "ROADMAP.md queue 1 item 15, multi-GPU")


def solve_half(V: torch.Tensor, bucketed: BucketedRatings | DeviceBucketedRatings,
               rank: int, lam: float, implicit: bool = False, alpha: float = 40.0,
               matmul_dtype: str = "float32",
               shard_factors: bool = False, cg_steps: int | None = None,
               solver: str = "cg", cg_matvec_dtype: str = "float32") -> torch.Tensor:
    """One half-step: all row factors of ``bucketed`` given the opposite
    factors ``V`` (on the device the rows are solved on). Returns a
    (num_rows, K) f32 table, zero for rows with no ratings. Host buckets
    are staged for this call; pass :func:`stage_buckets`'s result when
    calling repeatedly."""
    if shard_factors:
        raise NotImplementedError(_SHARDED_ITEM)
    bf16 = _check_matmul_dtype(matmul_dtype)
    _check_solver(solver)
    cg_bf16 = _resolve_cg_matvec(cg_matvec_dtype, rank)
    if isinstance(bucketed, BucketedRatings):
        bucketed = stage_buckets(bucketed, rank, device=V.device)
    return _solve_half_fused(V.float(), bucketed, float(lam), float(alpha), implicit,
                             bf16, cg_steps, solver, cg_bf16)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ALSFactors:
    user: torch.Tensor  # (num_users, K)
    item: torch.Tensor  # (num_items, K)


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
              matmul_dtype: str = "bfloat16",
              layout: str = "auto", cg_steps: int | None = None, solver: str = "cg",
              shard_factors: bool = False, cg_matvec_dtype: str = "auto",
              item0: np.ndarray | torch.Tensor | None = None,
              device: str | torch.device | None = None) -> ALSFactors:
    """Full alternating-least-squares training on ``device`` (default
    ``cuda``), with the semantics of MLlib ``ALS.train`` /
    ``ALS.trainImplicit``.

    ``layout`` "auto" and "fused" both take the ladder layout (the JAX
    default). ``matmul_dtype="bfloat16"`` (default) builds the normal
    equations from bf16 operands with f32 accumulation; "float32" in
    true f32. ``cg_matvec_dtype="auto"`` streams the CG matrix in bf16
    at rank >= 64. ``solver="cholesky"`` solves exactly. ``item0`` is
    the (num_items, rank) starting table; without it
    :func:`init_item_factors` draws one from ``seed``."""
    if layout in ("chunked", "bucketed"):
        raise NotImplementedError(
            f"layout={layout!r} is not ported: ROADMAP.md queue 1 item 16, "
            "the chunked and bucketed ALS layouts")
    if layout not in ("auto", "fused"):
        raise ValueError(f"layout must be 'auto', 'fused', 'chunked' or 'bucketed', "
                         f"got {layout!r}")
    if shard_factors:
        raise NotImplementedError(_SHARDED_ITEM)
    bf16 = _check_matmul_dtype(matmul_dtype)
    _check_solver(solver)
    cg_bf16 = _resolve_cg_matvec(cg_matvec_dtype, rank)
    dev = resolve_device(device)
    if item0 is None:
        item0 = init_item_factors(ratings.num_cols, rank, seed)
    if isinstance(item0, np.ndarray):
        item0 = torch.from_numpy(np.array(item0, dtype=np.float32))
    item0 = item0.float()
    if tuple(item0.shape) != (ratings.num_cols, rank):
        raise ValueError(f"item0 has shape {tuple(item0.shape)}, expected "
                         f"({ratings.num_cols}, {rank})")
    by_user = ladder_rows(ratings)
    by_item = ladder_rows(ratings.transpose())
    logger.info("ALS(fused): %d ratings, %d users (%d buckets), %d items (%d buckets), "
                "rank %d, on %s", ratings.nnz, ratings.num_rows, len(by_user.buckets),
                ratings.num_cols, len(by_item.buckets), rank, dev)
    dev_user = stage_buckets(by_user, rank, device=dev)
    dev_item = stage_buckets(by_item, rank, device=dev)
    user, item = _als_iterate_fused(item0.to(dev), dev_user, dev_item, iterations,
                                    float(lam), float(alpha), implicit, bf16, cg_steps,
                                    solver, cg_bf16)
    return ALSFactors(user=user, item=item)


# ---------------------------------------------------------------------------
# Prediction helpers
# ---------------------------------------------------------------------------


def predict_ratings(user_f: torch.Tensor, item_f: torch.Tensor, users, items) -> torch.Tensor:
    """Pointwise predicted ratings for (user, item) index pairs."""
    users = torch.as_tensor(users, device=user_f.device).long()
    items = torch.as_tensor(items, device=item_f.device).long()
    with ieee_f32():
        return (user_f[users] * item_f[items]).sum(-1)


def rmse(factors: ALSFactors, ratings: RatingsCOO, chunk: int = 1 << 20) -> float:
    """Root-mean-square error over the rating set, in chunks, summed on
    the device and read once."""
    total = torch.zeros((), dtype=torch.float64, device=factors.user.device)
    for s in range(0, ratings.nnz, chunk):
        e = min(s + chunk, ratings.nnz)
        pred = predict_ratings(factors.user, factors.item, ratings.rows[s:e],
                               ratings.cols[s:e])
        err = pred - torch.from_numpy(ratings.vals[s:e]).to(pred.device)
        total += (err.double() ** 2).sum()
    return math.sqrt(float(total) / max(ratings.nnz, 1))
