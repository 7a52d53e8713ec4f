"""The least time of one forward attention launch, from shapes and real
lengths alone, so the bound reads the same work whatever kernel
implements it.

Only real rows count: padding is the program's choice, not work the
answer needs. A right-padded row of real length L (capped at the
launch's S positions) holds L real queries and L real keys. Work: the
L(L+1)/2 causal (query, key) pairs among them, at 4·D FLOPs (QK^T and
PV) per head. Bytes: q, k, v and the output of the L real positions
once, in their dtype, and the f32 key mask of the L real keys once.
"""

from __future__ import annotations

from typing import Sequence


def _real(S: int, lengths: Sequence[int]) -> list[int]:
    return [min(int(L), S) for L in lengths]


def causal_pairs(S: int, lengths: Sequence[int]) -> int:
    """Causal (query, key) pairs among the real positions of a (B, S)
    right-padded batch whose rows hold ``lengths`` real items: sum over
    rows of L(L+1)/2."""
    return sum(L * (L + 1) // 2 for L in _real(S, lengths))


def attention_launch(S: int, heads: int, head_dim: int, lengths: Sequence[int],
                     dtype_bytes: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) one causal launch over a (len(lengths), heads, S,
    head_dim) batch needs for its real rows."""
    flops = 4.0 * head_dim * heads * causal_pairs(S, lengths)
    real = sum(_real(S, lengths))
    nbytes = 4.0 * real * heads * head_dim * dtype_bytes + 4.0 * real
    return flops, nbytes


def bound_s(S: int, heads: int, head_dim: int, lengths: Sequence[int], peaks: dict,
            dtype_bytes: int = 2) -> tuple[float, str]:
    """(least seconds, what bounds it: "operations" or "bytes") of one
    launch on a card with ``peaks`` (``roofline/peaks.py``)."""
    flops, nbytes = attention_launch(S, heads, head_dim, lengths, dtype_bytes)
    t_ops = flops / peaks["bf16_flops"]
    t_bytes = nbytes / peaks["hbm_bytes"]
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
