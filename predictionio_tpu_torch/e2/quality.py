"""Quality-parity harness: independent NumPy ALS-WR + ranking metrics
(port of the JAX package's ``e2/quality.py``; the NumPy estimator, the
splits and the metrics are copied line for line, and the device path is
the port's ``ops/als.als_train`` on the card unless the caller passes
``device="cpu"``).

Result keys are the JAX package's, so a record of either package reads
the same: in the port, ``_tpu`` names the device-path ALS (``map10_tpu``,
``rmse_tpu``, ``precision10_tpu``), which runs on the card, or over a
device ``mesh`` (``parallel/mesh.py``) when one is passed.

The north-star gate (BASELINE.md) is throughput *at matching MAP@10* —
speed claims are meaningless if the device factorizer converges to worse
factors than the reference's MLlib ALS
(reference: tests/pio_tests/engines/recommendation-engine/src/main/scala/
ALSAlgorithm.scala:79-93 and Evaluation.scala's Precision@K protocol).
Spark/MLlib cannot run in this environment (no JVM), so the comparison
point is an **independent NumPy implementation of the same ALS-WR
math** — the estimator MLlib's `ALS.train` computes — sharing *no code
or data layout* with the device path: it uses sort + ``np.add.reduceat``
segment reductions where the device path uses padded slab buckets
(ops/als.py), so it cross-checks the bucketing/masking machinery as well
as the solver.

Metrics follow the reference evaluation protocol: k-fold split over
rating rows, per-user top-k over items unseen in training,
Precision@K / MAP@K with a rating threshold defining relevance
(Evaluation.scala PrecisionAtK: tpCount / min(k, |positives|)). A
popularity baseline anchors the scale: a factorizer that fails to beat
most-popular recommendations has not learned personalization.
"""

from __future__ import annotations

import numpy as np

from predictionio_tpu_torch.data.movielens import RatingsDataset

def _device_als(coo_args, mesh, device, **kw):
    """The port's ``ops/als.als_train`` on ``device``, or over ``mesh``;
    its factors come back to the host as f32 NumPy, where the metrics
    run."""
    from predictionio_tpu_torch.ops.als import RatingsCOO, als_train

    f = als_train(RatingsCOO(*coo_args), device=device, mesh=mesh, **kw)
    return (np.asarray(f.user.cpu(), dtype=np.float32),
            np.asarray(f.item.cpu(), dtype=np.float32))


# ---------------------------------------------------------------------------
# Splits
# ---------------------------------------------------------------------------


def kfold_split(
    ds: RatingsDataset, k_fold: int = 5, fold: int = 0, seed: int = 3
) -> tuple[RatingsDataset, dict[int, list[tuple[int, float]]]]:
    """Reference protocol: assign each rating row to one of ``k_fold``
    folds (DataSource.scala:82-105 uses zipWithUniqueId % kFold; a seeded
    permutation gives the same exchangeable split deterministically).
    Returns (training fold, test ratings grouped per user)."""
    rng = np.random.default_rng(seed)
    fold_of = rng.permutation(ds.nnz) % k_fold
    test = fold_of == fold
    train = RatingsDataset(
        users=ds.users[~test],
        items=ds.items[~test],
        ratings=ds.ratings[~test],
        num_users=ds.num_users,
        num_items=ds.num_items,
    )
    test_by_user: dict[int, list[tuple[int, float]]] = {}
    for u, i, r in zip(ds.users[test], ds.items[test], ds.ratings[test]):
        test_by_user.setdefault(int(u), []).append((int(i), float(r)))
    return train, test_by_user


# ---------------------------------------------------------------------------
# Independent NumPy ALS-WR (the MLlib-equivalent estimator)
# ---------------------------------------------------------------------------


def _segment_half_solve(
    V: np.ndarray,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    num_rows: int,
    lam: float,
) -> np.ndarray:
    """One ALS-WR half-step: for every row entity solve
    (F^T F + lam * n I) x = F^T r over its observed column factors.
    Segment layout: sort by row, reduce contiguous runs with
    ``np.add.reduceat`` — no padding, no bucketing."""
    rank = V.shape[1]
    order = np.argsort(rows, kind="stable")
    r_sorted = rows[order]
    F = V[cols[order]]                                  # (nnz, K)
    seg_rows, seg_starts = np.unique(r_sorted, return_index=True)
    counts = np.diff(np.append(seg_starts, len(r_sorted)))

    outer = F[:, :, None] * F[:, None, :]
    A = np.add.reduceat(outer.reshape(len(F), rank * rank), seg_starts, axis=0)
    A = A.reshape(-1, rank, rank)
    A += (lam * counts)[:, None, None] * np.eye(rank, dtype=V.dtype)
    b = np.add.reduceat(F * vals[order][:, None], seg_starts, axis=0)

    out = np.zeros((num_rows, rank), dtype=V.dtype)
    out[seg_rows] = np.linalg.solve(A, b[..., None])[..., 0]
    return out


def numpy_als_wr(
    ds: RatingsDataset,
    rank: int = 10,
    iterations: int = 10,
    lam: float = 0.01,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Reference-math ALS: alternating ALS-WR half-steps, item factors
    initialized N(0,1)/sqrt(rank), users solved first — the `ALS.train`
    estimator (ALSAlgorithm.scala:79-85) in plain NumPy."""
    rng = np.random.default_rng(seed)
    V = (rng.standard_normal((ds.num_items, rank)) / np.sqrt(rank)).astype(
        np.float32
    )
    U = np.zeros((ds.num_users, rank), dtype=np.float32)
    for _ in range(iterations):
        U = _segment_half_solve(V, ds.users, ds.items, ds.ratings,
                                ds.num_users, lam)
        V = _segment_half_solve(U, ds.items, ds.users, ds.ratings,
                                ds.num_items, lam)
    return U, V


def _rowloop_half_solve(
    V: np.ndarray,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    num_rows: int,
    lam: float,
) -> np.ndarray:
    """One exact ALS-WR half-step via a per-row BLAS loop. Same
    estimator as :func:`_segment_half_solve` but memory-bounded at
    O(K^2) per row instead of materialising (nnz, K, K) outer products
    — the only way to run the oracle at BASELINE rank 200, where the
    segment formulation would allocate nnz * 160 KB."""
    rank = V.shape[1]
    order = np.argsort(rows, kind="stable")
    r_sorted = rows[order]
    c_sorted = cols[order]
    v_sorted = vals[order]
    seg_rows, seg_starts = np.unique(r_sorted, return_index=True)
    bounds = np.append(seg_starts, len(r_sorted))
    # pio: lint-ignore[dtype-discipline]: exact normal-equation oracle — f64 keeps the rank-200 solve conditioned; host-side, never ships to the device
    out = np.zeros((num_rows, rank), dtype=np.float64)
    eye = np.eye(rank, dtype=np.float64)  # pio: lint-ignore[dtype-discipline]: same f64 oracle solve as above
    for j, row in enumerate(seg_rows):
        lo, hi = bounds[j], bounds[j + 1]
        F = V[c_sorted[lo:hi]].astype(np.float64)  # pio: lint-ignore[dtype-discipline]: same f64 oracle solve as above
        A = F.T @ F + lam * (hi - lo) * eye
        b = F.T @ v_sorted[lo:hi].astype(np.float64)  # pio: lint-ignore[dtype-discipline]: same f64 oracle solve as above
        out[row] = np.linalg.solve(A, b)
    return out.astype(np.float32)


def numpy_als_wr_rowloop(
    ds: RatingsDataset,
    rank: int,
    iterations: int = 5,
    lam: float = 0.1,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """High-rank variant of :func:`numpy_als_wr` (exact solves, per-row
    loop) — the rank-200 parity oracle for the bench."""
    rng = np.random.default_rng(seed)
    V = (rng.standard_normal((ds.num_items, rank)) / np.sqrt(rank)).astype(
        np.float32
    )
    U = np.zeros((ds.num_users, rank), dtype=np.float32)
    for _ in range(iterations):
        U = _rowloop_half_solve(V, ds.users, ds.items, ds.ratings,
                                ds.num_users, lam)
        V = _rowloop_half_solve(U, ds.items, ds.users, ds.ratings,
                                ds.num_items, lam)
    return U, V


# ---------------------------------------------------------------------------
# Ranking metrics (reference Evaluation.scala protocol)
# ---------------------------------------------------------------------------


def _topk_unseen(
    scores: np.ndarray, train: RatingsDataset, users: np.ndarray, k: int
) -> np.ndarray:
    """Top-k item indices per requested user, excluding training-seen
    items (the serving path's exclude_seen semantics). ``scores`` is
    already row-aligned with ``users``."""
    sub = scores.copy()
    pos_of = {int(u): j for j, u in enumerate(users)}
    for u, i in zip(train.users, train.items):
        j = pos_of.get(int(u))
        if j is not None:
            sub[j, i] = -np.inf
    part = np.argpartition(-sub, k, axis=1)[:, :k]
    part_scores = np.take_along_axis(sub, part, axis=1)
    order = np.argsort(-part_scores, axis=1)
    return np.take_along_axis(part, order, axis=1)


def ranking_eval(
    score_fn,
    train: RatingsDataset,
    test_by_user: dict[int, list[tuple[int, float]]],
    k: int = 10,
    threshold: float = 4.0,
) -> dict[str, float]:
    """MAP@k / Precision@k over held-out positives (rating >= threshold).

    ``score_fn(users) -> (len(users), num_items)`` scores; users whose
    held-out set has no positives are skipped (OptionAverageMetric
    contract, Evaluation.scala:40-45)."""
    users = np.asarray(sorted(test_by_user), dtype=np.int32)
    scores = score_fn(users)
    topk = _topk_unseen(scores, train, users, k)

    maps, precs = [], []
    for j, u in enumerate(users):
        positives = {i for i, r in test_by_user[int(u)] if r >= threshold}
        if not positives:
            continue
        denom = min(k, len(positives))
        hits, ap = 0, 0.0
        for rank_pos, item in enumerate(topk[j], start=1):
            if int(item) in positives:
                hits += 1
                ap += hits / rank_pos
        maps.append(ap / denom)
        precs.append(hits / denom)
    return {
        f"map@{k}": float(np.mean(maps)) if maps else 0.0,
        f"precision@{k}": float(np.mean(precs)) if precs else 0.0,
        "evaluated_users": len(maps),
    }


def factor_score_fn(U: np.ndarray, V: np.ndarray):
    return lambda users: np.asarray(U)[users] @ np.asarray(V).T


def test_rmse(
    U: np.ndarray,
    V: np.ndarray,
    test_by_user: dict[int, list[tuple[int, float]]],
) -> float:
    """Held-out RMSE of the rating predictions — the estimator's native
    objective and the *sharp* parity metric: two correct ALS-WR
    implementations at the same hyperparameters must land within
    seed-level noise of each other here."""
    U, V = np.asarray(U), np.asarray(V)
    users = np.asarray(
        [u for u, lst in test_by_user.items() for _ in lst], dtype=np.int64
    )
    items = np.asarray(
        [i for lst in test_by_user.values() for i, _ in lst], dtype=np.int64
    )
    vals = np.asarray(
        # pio: lint-ignore[dtype-discipline]: parity-oracle RMSE accumulates in f64 so the noise floor compares implementations, not summation error
        [r for lst in test_by_user.values() for _, r in lst], dtype=np.float64
    )
    pred = np.einsum("nk,nk->n", U[users], V[items])
    return float(np.sqrt(np.mean((pred - vals) ** 2)))


def popularity_score_fn(train: RatingsDataset):
    """Non-personalized anchor: score every item by its training rating
    count (same for all users)."""
    counts = np.bincount(train.items, minlength=train.num_items).astype(
        np.float32
    )
    return lambda users: np.broadcast_to(
        counts, (len(users), train.num_items)
    ).copy()


# ---------------------------------------------------------------------------
# The parity comparison
# ---------------------------------------------------------------------------


#: implicit-ALS config for :func:`compare_quality`'s ranking measurement
#: (selected by sweep on the preference-coupled ML-100k-statistics set:
#: rank 10 / alpha 5 / lam 0.1 gives MAP@10 ~2.1x popularity; larger
#: alpha or rank over-weights the sparse positives and decays toward or
#: below the popularity anchor)
IMPLICIT_RANK = 10
IMPLICIT_ALPHA = 5.0
IMPLICIT_LAM = 0.1


def implicit_ranking_eval(
    train: RatingsDataset,
    test_by_user: dict[int, list[tuple[int, float]]],
    k: int = 10,
    threshold: float = 4.0,
    seed: int = 3,
    mesh=None,
    device=None,
) -> dict[str, float]:
    """MAP@k of the implicit-feedback ALS path — the framework's
    production ranking story (the ecommerce template's `trainImplicit`
    analogue, reference: examples/scala-parallel-ecommercerecommendation/
    ecomm/src/main/scala/ALSAlgorithm.scala). Ratings >= ``threshold``
    binarize to unit-confidence interactions; ranking scores are the
    factor dot products."""
    keep = train.ratings >= threshold
    coo = (
        train.users[keep], train.items[keep],
        np.ones(int(keep.sum()), dtype=np.float32),
        train.num_users, train.num_items,
    )
    U, V = _device_als(coo, mesh, device, rank=IMPLICIT_RANK, iterations=10,
                       lam=IMPLICIT_LAM, implicit=True, alpha=IMPLICIT_ALPHA, seed=seed)
    return ranking_eval(factor_score_fn(U, V), train,
                        test_by_user, k=k, threshold=threshold)


def implicit_vs_popularity_kfold(
    ds: RatingsDataset,
    k_fold: int = 5,
    k: int = 10,
    threshold: float = 4.0,
    seed: int = 3,
    device=None,
) -> dict[str, float]:
    """Mean MAP@k of the implicit path vs the popularity baseline over
    ALL folds — the protocol shared by the bench's real-data keys
    (``map10_*_real``) and the off-generator gating test, hoisted here
    so the two cannot drift (ADVICE-style round-4 review finding)."""
    imps, pops = [], []
    for fold in range(k_fold):
        train, test = kfold_split(ds, k_fold=k_fold, fold=fold, seed=seed)
        pops.append(ranking_eval(
            popularity_score_fn(train), train, test, k=k,
            threshold=threshold)[f"map@{k}"])
        imps.append(implicit_ranking_eval(
            train, test, k=k, threshold=threshold, seed=seed,
            device=device)[f"map@{k}"])
    return {
        f"map{k}_implicit": float(np.mean(imps)),
        f"map{k}_popularity": float(np.mean(pops)),
    }


def compare_quality(
    ds: RatingsDataset,
    rank: int = 10,
    iterations: int = 10,
    lam: float = 0.01,
    k: int = 10,
    threshold: float = 4.0,
    k_fold: int = 5,
    seed: int = 3,
    mesh=None,
    device=None,
) -> dict[str, float]:
    """Train the device-path ALS (ops/als.als_train) and the independent
    NumPy ALS-WR on the same fold; evaluate both plus the popularity
    baseline AND the implicit-feedback ranking path under the identical
    protocol. Returns a flat metric dict (the bench harness embeds it in
    the BENCH JSON line).

    Two quality axes, stated plainly: ``rmse_*``/``map{k}_tpu`` vs
    ``map{k}_ref`` are *parity* metrics (same estimator, two
    implementations — they must agree); ``map{k}_implicit`` vs
    ``map{k}_popularity`` is the *ranking-wins* metric — explicit ALS
    models rating values, not interaction propensity, and loses to the
    popularity baseline on top-N (MLlib's does too); the implicit path
    is the production ranking story and must beat popularity."""
    train, test_by_user = kfold_split(ds, k_fold=k_fold, seed=seed)

    fu, fi = _device_als(
        (train.users, train.items, train.ratings,
         train.num_users, train.num_items),
        mesh, device, rank=rank, iterations=iterations, lam=lam, seed=seed,
    )
    tpu = ranking_eval(
        factor_score_fn(fu, fi), train, test_by_user,
        k=k, threshold=threshold,
    )
    rmse_tpu = test_rmse(fu, fi, test_by_user)

    U, V = numpy_als_wr(train, rank=rank, iterations=iterations, lam=lam,
                        seed=seed + 1)
    ref = ranking_eval(factor_score_fn(U, V), train, test_by_user,
                       k=k, threshold=threshold)
    rmse_ref = test_rmse(U, V, test_by_user)

    pop = ranking_eval(popularity_score_fn(train), train, test_by_user,
                       k=k, threshold=threshold)
    imp = implicit_ranking_eval(train, test_by_user, k=k,
                                threshold=threshold, seed=seed, mesh=mesh,
                                device=device)

    return {
        f"map{k}_tpu": round(tpu[f"map@{k}"], 4),
        f"map{k}_ref": round(ref[f"map@{k}"], 4),
        f"map{k}_popularity": round(pop[f"map@{k}"], 4),
        f"map{k}_implicit": round(imp[f"map@{k}"], 4),
        f"precision{k}_tpu": round(tpu[f"precision@{k}"], 4),
        f"precision{k}_ref": round(ref[f"precision@{k}"], 4),
        "rmse_tpu": round(rmse_tpu, 4),
        "rmse_ref": round(rmse_ref, 4),
        "evaluated_users": tpu["evaluated_users"],
    }
