"""Rotary position embeddings: cos/sin tables and their application to
q and k, for ``models/moe_seqrec.py``. No kernel of its own: the
application is two products and an add per element on the card.

Tables follow ``transformers.modeling_rope_utils`` for the two kinds a
config's ``rope_parameters`` names per layer type:

- ``"default"``: inverse frequencies ``θ^(-2i/d)`` for i < d/2, attention
  factor 1;
- ``"yarn"`` (arXiv:2309.00071, as ``_compute_yarn_parameters``): the
  interpolated (``/ factor``) and extrapolated frequencies blended by a
  linear ramp over the dimensions whose rotations over
  ``original_max_position_embeddings`` positions lie between
  ``beta_slow`` and ``beta_fast`` (ends floored and ceiled unless
  ``truncate`` is false), and cos and sin multiplied by
  ``attention_factor`` (``0.1·ln(factor) + 1`` when the config gives
  none).

A table is ``(cos, sin)``, each (positions, head_dim) in float32: the
frequencies concatenated with themselves, the rotate-half convention.
:func:`apply` rounds them to the operand's dtype first, as transformers
does, and computes ``x·cos + rotate_half(x)·sin``.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch


def inverse_frequencies(params: Mapping, head_dim: int) -> tuple[torch.Tensor, float]:
    """``(inv_freq (head_dim/2,) f32, attention factor)`` of one layer
    kind's ``rope_parameters`` entry."""
    base = float(params["rope_theta"])
    dim = head_dim
    kind = params.get("rope_type", "default")
    pos_freqs = base ** (torch.arange(0, dim, 2, dtype=torch.int64).float() / dim)
    if kind == "default":
        return 1.0 / pos_freqs, 1.0
    if kind != "yarn":
        raise ValueError(f"rope_type {kind!r} is not supported (default or yarn)")
    factor = float(params["factor"])
    attention_factor = params.get("attention_factor")
    if attention_factor is None:
        attention_factor = 0.1 * math.log(factor) + 1.0 if factor > 1 else 1.0
    beta_fast = params.get("beta_fast") or 32
    beta_slow = params.get("beta_slow") or 1
    original = params["original_max_position_embeddings"]

    def correction_dim(rotations: float) -> float:
        return (dim * math.log(original / (rotations * 2 * math.pi))) / (2 * math.log(base))

    low, high = correction_dim(beta_fast), correction_dim(beta_slow)
    if params.get("truncate", True):
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    extrapolation = 1 - ramp
    inv_freq = (1.0 / (factor * pos_freqs)) * (1 - extrapolation) + (1.0 / pos_freqs) * extrapolation
    return inv_freq, float(attention_factor)


def table(params: Mapping, head_dim: int, positions: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)``, each (positions, head_dim) f32, scaled by the
    kind's attention factor."""
    inv_freq, scale = inverse_frequencies(params, head_dim)
    freqs = torch.arange(positions, dtype=torch.float32)[:, None] * inv_freq[None, :]
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos() * scale, emb.sin() * scale


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat((-x[..., half:], x[..., :half]), dim=-1)


def apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x`` (..., S, H, head_dim) rotated by the tables' first S rows
    (each (≥ S, head_dim)), in x's dtype."""
    S = x.shape[-3]
    c = cos[:S, None, :].to(x.dtype)
    s = sin[:S, None, :].to(x.dtype)
    return x * c + rotate_half(x) * s
