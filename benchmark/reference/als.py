"""The plain reference of explicit ALS-WR training (Zhou et al., 2008;
MLlib ``ALS.train``): from the ratings and the starting item table,
``iterations`` alternations of exact least-squares solves, users first.

A half-step solves, for every row u with n_u > 0 ratings,
``(Σ_r v_r v_rᵀ + λ·n_u·I) x_u = Σ_r r·v_r`` over its ratings r of
columns with factor v_r; a row with no rating gets x_u = 0. The sums are
built rating by rating (``index_add_`` of each rating's outer product,
in blocks of ratings so that they fit) and solved by Cholesky, all in
float64. ``rounding`` (``reference/lowp.py``) rounds the factor table
and the ratings before the products, for the control. Imports torch
only.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from benchmark.reference.lowp import exact

#: ratings per block of outer products: (block, K, K) float64 at K = 32
#: is 2 GiB
BLOCK = 1 << 18


def starting_items(num_items: int, rank: int, seed: int) -> torch.Tensor:
    """The starting item table that the recommendation template draws
    for ``seed``, as it documents it: standard normals from a CPU
    ``torch.Generator`` seeded with ``seed``, divided by sqrt(rank)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((num_items, rank), generator=gen, dtype=torch.float32) / math.sqrt(rank)


def half_step(V: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
              num_rows: int, lam: float,
              rounding: Callable[[torch.Tensor], torch.Tensor] = exact) -> torch.Tensor:
    """The (num_rows, K) float64 solutions against the opposite table V."""
    K = V.shape[1]
    dev = V.device
    Vr = rounding(V.double())
    vr = rounding(vals.double())
    A = torch.zeros((num_rows, K, K), dtype=torch.float64, device=dev)
    b = torch.zeros((num_rows, K), dtype=torch.float64, device=dev)
    for s in range(0, rows.shape[0], BLOCK):
        r, c, v = rows[s:s + BLOCK], cols[s:s + BLOCK], vr[s:s + BLOCK]
        F = Vr[c]
        A.index_add_(0, r, F[:, :, None] * F[:, None, :])
        b.index_add_(0, r, v[:, None] * F)
        del F
    n = torch.bincount(rows, minlength=num_rows).double()
    eye = torch.eye(K, dtype=torch.float64, device=dev)
    A += (lam * n)[:, None, None] * eye
    rated = n > 0
    A[~rated] = eye
    x = torch.cholesky_solve(b[..., None], torch.linalg.cholesky(A))[..., 0]
    x[~rated] = 0.0
    return x


def train(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, num_users: int,
          num_items: int, item0: torch.Tensor, iterations: int, lam: float,
          device: torch.device,
          rounding: Callable[[torch.Tensor], torch.Tensor] = exact
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(user table, item table), float64, after ``iterations``."""
    r = torch.as_tensor(rows, device=device).long()
    c = torch.as_tensor(cols, device=device).long()
    v = torch.as_tensor(vals, device=device).double()
    item = item0.to(device).double()
    user = None
    for _ in range(iterations):
        user = half_step(item, r, c, v, num_users, lam, rounding)
        item = half_step(user, c, r, v, num_items, lam, rounding)
    return user, item


def worst_row_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The largest gap between a row of the program's table and the
    reference's, ``|x_p - x_r|``, over the reference row's norm or the
    median row norm of the reference, whichever is larger (some rows are
    all but zero)."""
    ref = reference.double()
    gap = (program.to(ref.device).double() - ref).norm(dim=1)
    norms = ref.norm(dim=1)
    floor = norms.median()
    return float((gap / torch.maximum(norms, floor)).max())
