"""k-fold cross-validation splitting (a copy of the JAX package's
``e2/evaluation.py``).

Parity: e2/src/main/scala/.../e2/evaluation/CrossValidation.scala:24-76 —
``splitData`` assigns each record a fold by ``zipWithUniqueId % k`` and
yields, per fold, (training records, eval-info, (query, actual) pairs).
"""

from __future__ import annotations

from typing import Callable, Sequence, TypeVar

D = TypeVar("D")
TD = TypeVar("TD")
EI = TypeVar("EI")
Q = TypeVar("Q")
A = TypeVar("A")


def cross_validation_split(
    data: Sequence[D],
    k: int,
    make_training: Callable[[list[D]], TD],
    make_query_actual: Callable[[D], tuple[Q, A]],
    eval_info: EI = None,
) -> list[tuple[TD, EI, list[tuple[Q, A]]]]:
    """Split ``data`` into k folds: fold i evaluates on records whose
    index % k == i and trains on the rest (CrossValidation.scala:36-63).

    Index-based assignment keeps the split deterministic, like the
    reference's zipWithUniqueId — shuffle upstream if randomization is
    wanted.
    """
    if k <= 0:
        raise ValueError("k must be positive")
    folds = []
    for fold in range(k):
        train = [d for i, d in enumerate(data) if i % k != fold]
        held_out = [d for i, d in enumerate(data) if i % k == fold]
        qa = [make_query_actual(d) for d in held_out]
        folds.append((make_training(train), eval_info, qa))
    return folds
