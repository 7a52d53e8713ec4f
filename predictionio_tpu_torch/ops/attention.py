"""Plain single-device attention (port of ``full_attention`` in the JAX
package's ``ops/attention.py``). Blockwise and ring attention come with
the training and multi-GPU slices.
"""

from __future__ import annotations

import math

import torch

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
