"""The ALS cells' inputs, made from the run's seed: the rating triples
(rows are users, columns items), drawn by the traffic file's
distributions at the configuration's counts, and the seed of the
starting item table that the template draws.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from benchmark.harness import traffic as tr


def make_ratings(traffic: Mapping, cfg: Mapping, seed: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    return tr.triples(traffic["ratings"], cfg, tr.rng(seed, "data"))


def item_seed(seed: int) -> int:
    """The template's ``seed`` parameter for this run."""
    return tr.torch_seed(seed, "weights")


def seen_by_row(rows: np.ndarray, cols: np.ndarray, num_rows: int) -> dict[int, np.ndarray]:
    """Each row's distinct columns, sorted (what the template's
    preparator keeps as each user's seen items)."""
    width = int(cols.max()) + 1
    key = np.sort(rows.astype(np.int64) * width + cols)
    key = key[np.concatenate(([True], key[1:] != key[:-1]))]
    r, c = key // width, (key % width).astype(np.int32)
    cuts = np.searchsorted(r, np.arange(num_rows + 1))
    return {u: c[cuts[u]:cuts[u + 1]] for u in range(num_rows) if cuts[u + 1] > cuts[u]}
