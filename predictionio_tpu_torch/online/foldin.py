"""Closed-form ALS fold-in: the rank x rank normal-equation solves (a copy
of the JAX package's ``online/foldin.py``; the port imports nothing of
that package).

Folding one user between retrains needs only that user's row of the
normal equations: a rank x rank solve over the item vectors the user
touched, host NumPy, so the speed layer never recompiles anything.

- explicit ALS-WR:  ``A = Σ y yᵀ + λ n_u I``, ``b = Σ r y``
- implicit Hu-Koren: confidence ``c = 1 + α|r|``, preference
  ``p = [r > 0]``: ``A = YᵀY + Σ α|r| y yᵀ + λ I``,
  ``b = Σ (1 + α r)·[r>0] y``, where ``YᵀY`` is the gramian of the full
  item table (computed once per model generation by the caller).

Solving over the user's full interaction set (not a delta update) makes
fold-in idempotent: re-folding after a replayed tail read or a model
reload recomputes the same vector instead of double-counting events.

New items get :func:`popularity_prior`, the weighted centroid of the
catalog, and :func:`solve_item`, the symmetric solve, once known users
have rated them.
"""

from __future__ import annotations

import numpy as np


def _solve(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Solve the (K, K) normal system, falling back to least squares
    when the ridge was too weak to regularize a degenerate system."""
    try:
        return np.linalg.solve(A, b).astype(np.float32)
    except np.linalg.LinAlgError:
        return np.linalg.lstsq(A, b, rcond=None)[0].astype(np.float32)


def solve_user(item_vecs: np.ndarray, ratings: np.ndarray, lam: float,
               implicit: bool = False, alpha: float = 1.0,
               gram: np.ndarray | None = None) -> np.ndarray | None:
    """One user's closed-form factor vector from the item vectors of
    their full interaction set (module docstring has the model).

    ``item_vecs`` is (n, K) float32, ``ratings`` (n,); ``gram`` is the
    full-table ``YᵀY`` required in implicit mode. Returns (K,) float32,
    or None for an empty interaction set (nothing to say about this
    user — the caller keeps whatever vector the base model has)."""
    item_vecs = np.asarray(item_vecs, dtype=np.float32)
    ratings = np.asarray(ratings, dtype=np.float32)
    n = len(ratings)
    if n == 0:
        return None
    k = item_vecs.shape[1]
    eye = np.eye(k, dtype=np.float32)
    if implicit:
        if gram is None:
            raise ValueError("implicit fold-in needs the item gramian")
        w = alpha * np.abs(ratings)                       # (c - 1)
        A = gram + (item_vecs * w[:, None]).T @ item_vecs + lam * eye
        cp = np.where(ratings > 0, 1.0 + alpha * ratings, 0.0)
        b = cp @ item_vecs                                # Σ c p y
    else:
        A = item_vecs.T @ item_vecs + (lam * n) * eye
        b = ratings @ item_vecs
    return _solve(A, b.astype(np.float32))


def solve_item(user_vecs: np.ndarray, ratings: np.ndarray, lam: float,
               implicit: bool = False, alpha: float = 1.0,
               gram: np.ndarray | None = None) -> np.ndarray | None:
    """The symmetric solve: one ITEM's vector from the vectors of the
    users who rated it (ALS is symmetric in the two factor tables;
    ``gram`` is the full USER-table gramian in implicit mode)."""
    return solve_user(user_vecs, ratings, lam, implicit=implicit,
                      alpha=alpha, gram=gram)


def popularity_prior(item_factors: np.ndarray,
                     weights: np.ndarray | None = None) -> np.ndarray:
    """A cold-start vector for an item nobody known has rated yet: the
    (optionally popularity-weighted) centroid of the existing catalog —
    it scores every user by their affinity for the popular taste
    direction, which beats the all-zeros vector (never recommended)
    and any random direction (noise). Replaced by :func:`solve_item`
    as soon as real raters exist, and by the real trained vector at
    the next retrain."""
    table = np.asarray(item_factors, dtype=np.float32)
    if table.size == 0:
        return np.zeros((table.shape[-1] if table.ndim == 2 else 0,),
                        dtype=np.float32)
    if weights is not None:
        w = np.asarray(weights, dtype=np.float32)
        total = float(w.sum())
        if total > 0:
            return (table * (w / total)[:, None]).sum(axis=0)
    return table.mean(axis=0)


def item_gramian(factors: np.ndarray) -> np.ndarray:
    """``FᵀF`` of a factor table as float32 — the implicit-mode
    constant, computed once per model generation and cached by the
    service."""
    f = np.asarray(factors, dtype=np.float32)
    return f.T @ f
