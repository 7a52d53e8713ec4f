"""Static top-k widths for serving (port of ``serving_k`` in the JAX
package's ``ops/topk.py``; the rest of that module comes with the ALS
slice)."""

from __future__ import annotations

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
