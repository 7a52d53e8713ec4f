"""FLOPs of the sessionrec transformer's serving forward, from the
configuration's shapes and each query's real length: the work a query
needs, not what a padded batch executes.

Per real token of a query of length L, in each of the n_layers blocks:
the QKV projection 6·d², the output projection 2·d², the MLP 4·d·h
(h = mlp_mult·d); attention QK^T and PV over the L(L+1)/2 causal pairs
of real tokens, 4·d per pair over all heads; then the tied logits of the
last position against the V-row item table, 2·d·V. Layer norms, GELU
and the top-k are not counted (they are not matrix products).
"""

from __future__ import annotations

from typing import Mapping, Sequence


def query_forward_flops(cfg: Mapping, length: int) -> float:
    """FLOPs one query of ``length`` real items needs (capped at the
    configuration's ``max_len``: the program serves the latest max_len)."""
    d, V = cfg["d_model"], cfg["vocab"]
    h = cfg["mlp_mult"] * d
    L = min(int(length), cfg["max_len"])
    per_layer = L * (8.0 * d * d + 4.0 * d * h) + 4.0 * d * (L * (L + 1) / 2)
    return cfg["n_layers"] * per_layer + 2.0 * d * V


def batch_forward_flops(cfg: Mapping, lengths: Sequence[int]) -> float:
    return sum(query_forward_flops(cfg, L) for L in lengths)
