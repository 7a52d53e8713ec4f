"""Attention in torch (port of the JAX package's ``ops/attention.py``):
single-device ``full_attention`` and ``blockwise_attention``, and
``ring_attention`` over a mesh's sequence axis.

All three are differentiable and are the training routes of
``models/seqrec.py``; serving goes through ``ops/flash_attention.py``,
which is forward-only. They differ on a query row whose keys are all
masked (an all-PAD training row): ``full_attention`` gives it the uniform
average of V, the other two give it zero, as in the JAX package.

Ring attention (JAX's ``shard_map`` body, step for step): each mesh
position along "seq" holds one block of the sequence; K, V and the key
mask rotate around the ring (``parallel/mesh.ppermute``) while an online
softmax accumulates each query block's running max, denominator and
numerator in f32, so no position holds the whole sequence's logits.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from predictionio_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    ShardedArray,
    axis_index,
    device_put,
    local_map,
    ppermute,
)

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


def _ring_step(q_pos: torch.Tensor, k_pos: torch.Tensor, qf: torch.Tensor,
               k_blk: torch.Tensor, v_blk: torch.Tensor, mask_blk: torch.Tensor,
               m: torch.Tensor, l: torch.Tensor, o: torch.Tensor, scale: float,
               causal: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ring step at one position: the arriving K/V block (key
    positions ``k_pos``) folded into the running (max, denominator,
    numerator) of the local queries (positions ``q_pos``)."""
    logits = torch.einsum("bhsd,bhtd->bhst", qf, k_blk.float()) * scale
    valid = mask_blk[:, None, None, :].bool()
    if causal:
        valid = valid & (q_pos[:, None] >= k_pos[None, :])
    logits = torch.where(valid, logits, _NEG)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    # blocks that are entirely masked contribute nothing; alpha and p stay
    # finite because _NEG - _NEG == 0, and the seen-mask cancels exp(0) = 1
    seen = m_new > _NEG / 2
    alpha = torch.where(seen, torch.exp(m - m_new), 0.0)
    p = torch.exp(logits - m_new[..., None])
    p = torch.where(valid & seen[..., None], p, 0.0)
    l = l * alpha + p.sum(dim=-1)
    o = o * alpha[..., None] + torch.einsum("bhst,bhtd->bhsd", p, v_blk.float())
    return m_new, l, o


def ring_attention_sharded(
    q: ShardedArray,        # (B, H, S, D), S split over ``seq_axis``
    k: ShardedArray,
    v: ShardedArray,
    kv_mask: ShardedArray,  # (B, S) 1=real, 0=pad, S split over ``seq_axis``
    *,
    seq_axis: str = "seq",
    causal: bool = True,
) -> ShardedArray:
    """Sequence-parallel attention over per-position shards (B, H, S/n, D)
    of the mesh's ``seq_axis`` (n positions): at ring step i each position
    holds the block that started at position (idx - i) mod n, whose keys
    sit at ``src·(S/n) + arange(S/n)``. Returns per-position shards in q's
    dtype, zero for a query row with no valid key. Other mesh axes (a
    batch split over "data") just run side by side."""
    mesh = q.mesh
    n = mesh.axis_size(seq_axis)
    Sl, D = q.shards[0].shape[2], q.shards[0].shape[3]
    scale = float(np.float32(1.0 / math.sqrt(D)))

    def start(qs):
        B, H = qs.shape[:2]
        return (qs.float(),
                torch.full((B, H, Sl), _NEG, dtype=torch.float32, device=qs.device),
                torch.zeros((B, H, Sl), dtype=torch.float32, device=qs.device),
                torch.zeros((B, H, Sl, D), dtype=torch.float32, device=qs.device))

    qf, m, l, o = local_map(mesh, start, q, spec=q.spec)
    k_blk, v_blk, mask_blk = k, v, kv_mask
    for i in range(n):
        def step(pos, qf_, k_, v_, mask_, m_, l_, o_, i=i):
            idx = axis_index(mesh, pos, seq_axis)
            block = torch.arange(Sl, device=qf_.device)
            return _ring_step(idx * Sl + block, ((idx - i) % n) * Sl + block, qf_, k_, v_,
                              mask_, m_, l_, o_, scale, causal)

        m, l, o = local_map(mesh, step, qf, k_blk, v_blk, mask_blk, m, l, o, spec=q.spec,
                            with_pos=True)
        if i < n - 1:   # JAX rotates after the last step too; nothing reads that block
            k_blk, v_blk, mask_blk = (ppermute(x, seq_axis) for x in (k_blk, v_blk, mask_blk))

    def finish(l_, o_, q_):
        out = o_ / l_.clamp_min(1e-20)[..., None]
        return torch.where((l_ > 0)[..., None], out, 0.0).to(q_.dtype)

    return local_map(mesh, finish, l, o, q, spec=q.spec)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    *,
    seq_axis: str = "seq",
    causal: bool = True,
    kv_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`ring_attention_sharded` on whole (B, H, S, D) tensors, as
    JAX's ``ring_attention(q, k, v, mesh)`` takes them: S is split over
    ``mesh``'s ``seq_axis`` (it must divide the axis size), and the result
    comes back whole on the mesh's home device (a collective when the
    mesh spans processes)."""
    if kv_mask is None:
        kv_mask = torch.ones((q.shape[0], q.shape[2]), dtype=torch.float32, device=q.device)
    spec4 = NamedSharding(mesh, (None, None, seq_axis, None))
    out = ring_attention_sharded(
        *(device_put(x, spec4) for x in (q, k, v)),
        device_put(kv_mask, NamedSharding(mesh, (None, seq_axis))),
        seq_axis=seq_axis, causal=causal)
    return out.gather()
