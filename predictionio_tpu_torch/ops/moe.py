"""A sparse mixture-of-experts layer with SwiGLU experts, for
``models/moe_seqrec.py`` (the Qwen-MoE convention that Mellum-class
configs follow: softmax router, top-k, optional renormalisation of the
k weights, no shared expert).

:func:`route`: router logits ``x·W_r`` (E outputs), their softmax in
f32, the top k experts of each position, their weights renormalised to
sum to 1 when ``norm_topk_prob``, then rounded to x's dtype.

:func:`dispatch`: the (position, expert) pairs of the real positions,
sorted by expert, and each expert's end offset in that order. Padded
positions (``valid`` false) go to a sentinel expert E that sorts last and
that no product computes: they are never dispatched. Every count and
offset stays on the device: nothing here waits for the card.

:func:`experts`: the experts' SwiGLU over the sorted pairs as two
grouped products (``torch._grouped_mm``: on sm_90 PyTorch's grouped GEMM
reads each group's rows from the device-side offsets, so it needs no
count on the host), ``silu(gate)·up`` between them, then the weighted
combine: each pair's output times its weight, summed per position in
f32 and rounded to x's dtype. Rows of the pair buffer past the last real
pair (a capacity above the real count) are not computed by the grouped
products and are zeroed before the combine.

Weights keep the (in, out) layout: ``w_router`` (d, E), ``w_gate_up``
(E, d, 2f) with gate in the first f columns and up in the last f,
``w_down`` (E, f, d).

The layer's capacity is the number of pair rows it allocates. By default
it is every position's k pairs (always enough); a caller that knows an
upper bound of the real positions on the host (the sessionrec template
knows each row's length before the upload) passes it, so buffers and the
element-wise work scale with the real tokens, not the padded batch. A
bound below the real count would drop pairs: callers pass the exact
count or more.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def route(x: torch.Tensor, w_router: torch.Tensor, top_k: int, norm_topk_prob: bool
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(weights (N, k) in x's dtype, experts (N, k) int64)`` of the
    rows of ``x`` (N, d)."""
    probs = torch.softmax((x @ w_router).float(), dim=-1)
    weights, experts = torch.topk(probs, top_k, dim=-1)
    if norm_topk_prob:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights.to(x.dtype), experts


def dispatch(experts: torch.Tensor, valid: torch.Tensor, num_experts: int,
             capacity: int | None = None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(order, counts, offsets)``: the first ``capacity`` positions
    (default all N·k) of the flattened (N·k) pairs sorted by expert, real
    pairs first; the real pairs routed to each expert (E,) int64; each
    expert's end in ``order`` (E,) int32. Pair p is position p // k."""
    n_pairs = experts.numel()
    pair_expert = torch.where(valid[:, None], experts, num_experts).reshape(-1)
    order = torch.argsort(pair_expert, stable=True)
    cap = n_pairs if capacity is None else max(1, min(n_pairs, int(capacity)))
    # a scatter-add, not torch.bincount: on CUDA bincount reads the input's
    # largest value back to the host to size its output
    counts = torch.zeros(num_experts + 1, dtype=torch.int64, device=experts.device)
    counts = counts.scatter_add_(0, pair_expert, torch.ones_like(pair_expert))[:num_experts]
    offsets = counts.cumsum(0).to(torch.int32)
    return order[:cap], counts, offsets


def experts(x: torch.Tensor, weights: torch.Tensor, order: torch.Tensor,
            offsets: torch.Tensor, w_gate_up: torch.Tensor, w_down: torch.Tensor
            ) -> torch.Tensor:
    """The layer's output (N, d) in x's dtype: for each position the
    weighted sum of its routed experts' SwiGLU; 0 at positions with no
    dispatched pair."""
    k = weights.shape[1]
    f = w_down.shape[1]
    token = order // k
    # rows offsets[e-1]:offsets[e] times expert e's matrix; rows past
    # offsets[-1] are left undefined
    h = torch._grouped_mm(x[token], w_gate_up, offs=offsets)
    a = F.silu(h[:, :f]) * h[:, f:]
    y = torch._grouped_mm(a, w_down, offs=offsets)
    computed = torch.arange(order.shape[0], device=x.device) < offsets[-1]
    y = torch.where(computed[:, None], y * weights.reshape(-1)[order][:, None], 0)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    return out.index_add_(0, token, y.float()).to(x.dtype)
