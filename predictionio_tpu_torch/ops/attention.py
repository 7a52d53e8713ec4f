"""Plain single-device attention (port of ``full_attention`` and
``blockwise_attention`` in the JAX package's ``ops/attention.py``).
Ring attention comes with the multi-GPU slice.

Both are differentiable and are the training routes of
``models/seqrec.py``; serving goes through ``ops/flash_attention.py``,
which is forward-only. They differ on a query row whose keys are all
masked (an all-PAD training row): ``full_attention`` gives it the uniform
average of V, ``blockwise_attention`` gives it zero, as in the JAX
package.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

_NEG = -1e30  # large-negative instead of -inf: keeps exp() NaN-free


def full_attention(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, H, S, D)
    v: torch.Tensor,  # (B, H, S, D)
    *,
    causal: bool = True,
    kv_mask: torch.Tensor | None = None,  # (B, S) 1=real, 0=pad
) -> torch.Tensor:
    """Reference attention; returns (B, H, S, D) in q.dtype. Logits and
    softmax are f32. A fully-masked row gets the uniform average of V
    (softmax over equal -1e30 logits), as in the JAX function."""
    d = q.shape[-1]
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float())
    logits = logits / math.sqrt(d)
    neg = torch.tensor(_NEG, dtype=torch.float32, device=q.device)
    if causal:
        s, t = logits.shape[-2], logits.shape[-1]
        cmask = torch.ones((s, t), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(cmask, logits, neg)
    if kv_mask is not None:
        logits = torch.where(kv_mask[:, None, None, :].bool(), logits, neg)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs, v.float()).to(q.dtype)


def blockwise_attention(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, H, S, D)
    v: torch.Tensor,  # (B, H, S, D)
    *,
    causal: bool = True,
    kv_mask: torch.Tensor | None = None,  # (B, S)
    q_block: int | None = None,
) -> torch.Tensor:
    """Memory-bounded, differentiable attention: a loop over query tiles,
    each computing its (q_block, S) f32 logits and softmax under
    ``torch.utils.checkpoint``, so the backward pass recomputes a tile's
    logits and peak memory is O(B·H·q_block·S) instead of O(B·H·S²).

    ``q_block=None`` picks the largest of (128, 64, 32, 16, 8) that
    divides S, else S (one tile). An explicit q_block must divide S
    (raises ValueError otherwise). Rows with no valid key get zero."""
    B, H, S, D = q.shape
    if kv_mask is None:
        kv_mask = torch.ones((B, S), dtype=torch.float32, device=q.device)
    if q_block is None:
        q_block = next((b for b in (128, 64, 32, 16, 8) if S % b == 0), S)
    q_block = min(q_block, S)
    if S % q_block:
        raise ValueError(f"S={S} must divide by q_block={q_block}")
    # the JAX function multiplies by an f32 1/sqrt(D); full_attention divides
    scale = float(np.float32(1.0 / math.sqrt(D)))
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(S, device=q.device)
    valid_k = kv_mask[:, None, None, :].bool()                  # (B, 1, 1, S)

    def tile(q_tile: torch.Tensor, start: int) -> torch.Tensor:
        logits = torch.einsum("bhsd,bhtd->bhst", q_tile.float(), kf) * scale
        valid = valid_k
        if causal:
            q_pos = start + torch.arange(q_block, device=q.device)
            valid = valid & (q_pos[:, None] >= k_pos[None, :])
        logits = torch.where(valid, logits, _NEG)
        probs = torch.softmax(logits, dim=-1)
        # fully-masked rows (padding queries) get zero output
        probs = torch.where(valid.any(dim=-1, keepdim=True), probs, 0.0)
        return torch.einsum("bhst,bhtd->bhsd", probs, vf).to(q.dtype)

    tiles = [checkpoint(tile, q[:, :, s:s + q_block], s, use_reentrant=False)
             for s in range(0, S, q_block)]
    return torch.cat(tiles, dim=2)
