"""Work and least times of the MoE sessionrec model's serving forward,
from the configuration's shapes and each query's real length: the work
a query needs, not what a padded batch executes.

Per real token of a query of length L (capped at ``max_len``), in each
layer: the q, k, v projection 2·d·(H + 2·H_kv)·D, the output projection
2·H·D·d, the router 2·d·E, and its k experts' SwiGLU 6·d·f each;
attention 4·D·H per (query, key) pair, over the L(L+1)/2 causal pairs on
a full layer and Σ_i min(i + 1, W) on a sliding one (window W); then the
untied head of the last position, 2·d·V. Norms, RoPE, softmax, routing's
sort and the top-k are not counted (they are not matrix products).

The flash launch of one layer (:func:`flash_launch`): those pairs' 4·D·H
FLOPs; bytes of q and the output at H heads and k and v at H_kv heads,
for the real positions, in bf16, and the f32 key mask once. The expert
products of one layer (:func:`experts_layer`): the real tokens' k pairs'
6·d·f FLOPs; bytes of every expert's three matrices read once, and of
each pair's input row, intermediate and output rows once.
"""

from __future__ import annotations

from typing import Mapping, Sequence


def _layers(cfg: Mapping) -> list[str]:
    return list(cfg["layer_types"])[: int(cfg["num_hidden_layers"])]


def _real(cfg: Mapping, lengths: Sequence[int]) -> list[int]:
    return [min(int(L), int(cfg["max_len"])) for L in lengths]


def pairs(kind: str, L: int, window: int) -> int:
    """Causal (query, key) pairs among L real positions of one layer."""
    if kind == "sliding_attention" and L > window:
        return window * (window + 1) // 2 + (L - window) * window
    return L * (L + 1) // 2


def query_forward_flops(cfg: Mapping, length: int) -> float:
    d, V, D = cfg["hidden_size"], cfg["vocab_size"], cfg["head_dim"]
    H, Hkv, E = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["num_experts"]
    k, f, W = cfg["num_experts_per_tok"], cfg["moe_intermediate_size"], cfg["sliding_window"]
    L = _real(cfg, [length])[0]
    per_token = 2.0 * d * (H + 2 * Hkv) * D + 2.0 * H * D * d + 2.0 * d * E + k * 6.0 * d * f
    total = 0.0
    for kind in _layers(cfg):
        total += L * per_token + 4.0 * D * H * pairs(kind, L, W)
    return total + 2.0 * d * V


def batch_forward_flops(cfg: Mapping, lengths: Sequence[int]) -> float:
    return sum(query_forward_flops(cfg, L) for L in lengths)


def flash_launch(cfg: Mapping, kind: str, lengths: Sequence[int]) -> tuple[float, float]:
    """(FLOPs, bytes) one layer's flash launch needs for the real rows."""
    D, H, Hkv = cfg["head_dim"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    real = _real(cfg, lengths)
    flops = 4.0 * D * H * sum(pairs(kind, L, cfg["sliding_window"]) for L in real)
    nbytes = 2.0 * (2 * H + 2 * Hkv) * D * sum(real) + 4.0 * sum(real)
    return flops, nbytes


def experts_layer(cfg: Mapping, lengths: Sequence[int]) -> tuple[float, float]:
    """(FLOPs, bytes) one layer's routed expert products need."""
    d, E = cfg["hidden_size"], cfg["num_experts"]
    k, f = cfg["num_experts_per_tok"], cfg["moe_intermediate_size"]
    n_pairs = k * sum(_real(cfg, lengths))
    flops = 6.0 * d * f * n_pairs
    nbytes = 2.0 * (E * 3 * d * f + n_pairs * (d + 2 * f + f + d))
    return flops, nbytes


def least_s(work: tuple[float, float], peaks: Mapping) -> float:
    flops, nbytes = work
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes"])
