"""The plain reference of ``models/moe_seqrec.py``: one history's
next-item logits in float32, from the weights and the history alone.
Plain torch: no kernel of the port, no batching, no padding.

The block is the Mellum2 / Qwen-MoE decoder as its config.json and the
transformers conventions give it, run over item ids:

- ``x = item_emb[ids]``;
- per layer ``x += attn(RMSNorm(x))·W_o``: q, k, v from one (d, (H +
  2·H_kv)·D) product; RoPE on q and k (rotate-half, the layer type's
  table from ``rope_parameters``: plain, or YaRN with cos and sin times
  ``attention_factor``); each query head h reads KV head h // (H /
  H_kv); softmax over keys j with j <= i and, on sliding layers, j > i -
  sliding_window, scaled by 1/sqrt(D);
- then ``x += Σ_{e in top-k} w_e · (silu(h·G_e) ⊙ (h·U_e))·D_e`` with h
  = RMSNorm(x), router probabilities ``softmax(h·W_r)``, the top k
  renormalised to sum to 1 (``norm_topk_prob``), routed token by token
  by a loop over the experts;
- a final RMSNorm and the untied head at the last position.

RMSNorm is ``g · x / sqrt(mean(x²) + eps)``. The history is run at its
own length, so no padding and no key mask enter: under a causal mask the
padded keys of a right-padded batch never reach a real position.
Attention runs in blocks of queries so that 8,192 positions fit.

Departures from the published description, each a choice the config
leaves open: no q/k norm (the config names none); softmax router scoring;
attention scale 1/sqrt(head_dim); the MTP head is left out (no config key
and no role in one next-item distribution); only the first
``num_hidden_layers`` of ``layer_types`` run. Everything is float32 with
TF32 switched off; ``rounding`` rounds every product's operands (the
controls' lower precision); the identity by default. Imports torch only.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, Sequence

import torch
import torch.nn.functional as F

#: queries per block of the attention
Q_BLOCK = 512


def _exact(x: torch.Tensor) -> torch.Tensor:
    return x


def _rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return g * x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)


def _rope_table(params: Mapping, dim: int, L: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    base = float(params["rope_theta"])
    pos = base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    inv = 1.0 / pos
    scale = 1.0
    if params.get("rope_type", "default") == "yarn":
        factor = float(params["factor"])
        scale = params.get("attention_factor") or (0.1 * math.log(factor) + 1.0)
        orig = params["original_max_position_embeddings"]

        def corr(rot):
            return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

        lo, hi = corr(params.get("beta_fast") or 32), corr(params.get("beta_slow") or 1)
        if params.get("truncate", True):
            lo, hi = math.floor(lo), math.ceil(hi)
        lo, hi = max(lo, 0), min(hi, dim - 1)
        hi = hi + 0.001 if lo == hi else hi
        ramp = ((torch.arange(dim // 2, dtype=torch.float32) - lo) / (hi - lo)).clamp(0, 1)
        inv = inv / factor * ramp + inv * (1 - ramp)
    ang = torch.arange(L, dtype=torch.float32)[:, None] * inv[None, :]
    ang = torch.cat((ang, ang), dim=-1)
    return (ang.cos() * scale).to(device), (ang.sin() * scale).to(device)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return x * cos + torch.cat((-x[..., half:], x[..., :half]), dim=-1) * sin


def hidden(weights: Mapping[str, torch.Tensor], cfg: Mapping, history: Sequence[int],
           rounding: Callable[[torch.Tensor], torch.Tensor] = _exact) -> torch.Tensor:
    """(L, d) f32 final-normed hidden states of ``history`` (its latest
    ``max_len`` ids)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r, w = rounding, weights
    dev = w["item_emb"].device
    d, H, Hkv, D = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"], cfg["head_dim"])
    E, k, eps = cfg["num_experts"], cfg["num_experts_per_tok"], cfg["rms_norm_eps"]
    types = list(cfg["layer_types"])[: cfg.get("num_hidden_layers") or len(cfg["layer_types"])]
    seq = torch.as_tensor([int(i) for i in history][-cfg["max_len"]:], dtype=torch.int64,
                          device=dev)
    L = seq.shape[0]
    tables = {t: _rope_table(cfg["rope_parameters"][t], D, L, dev) for t in set(types)}
    x = w["item_emb"][seq].float()
    for i, kind in enumerate(types):
        p = f"layers.{i}."
        h = _rms(x, w[p + "attn_norm"].float(), eps)
        qkv = r(h) @ r(w[p + "wqkv"].float())
        q, kk, v = qkv.view(L, H + 2 * Hkv, D).split((H, Hkv, Hkv), dim=1)
        cos, sin = (t[:, None, :] for t in tables[kind])
        q, kk = _rotate(q, cos, sin), _rotate(kk, cos, sin)
        q = q.transpose(0, 1)                                              # (H, L, D)
        kk = kk.transpose(0, 1).repeat_interleave(H // Hkv, dim=0)         # (H, L, D)
        v = v.transpose(0, 1).repeat_interleave(H // Hkv, dim=0)
        out = torch.empty_like(q)
        keys = torch.arange(L, device=dev)
        for s in range(0, L, Q_BLOCK):
            rows = torch.arange(s, min(s + Q_BLOCK, L), device=dev)
            visible = keys[None, :] <= rows[:, None]
            if kind == "sliding_attention":
                visible &= keys[None, :] > rows[:, None] - cfg["sliding_window"]
            logits = (r(q[:, rows]) @ r(kk).transpose(1, 2)) / math.sqrt(D)
            att = torch.softmax(logits.masked_fill(~visible, float("-inf")), dim=-1)
            out[:, rows] = r(att) @ r(v)
        x = x + r(out.transpose(0, 1).reshape(L, H * D)) @ r(w[p + "wo"].float())
        h = _rms(x, w[p + "moe_norm"].float(), eps)
        probs = torch.softmax(r(h) @ r(w[p + "router"].float()), dim=-1)
        top_w, top_e = torch.topk(probs, k, dim=-1)
        if cfg.get("norm_topk_prob", True):
            top_w = top_w / top_w.sum(-1, keepdim=True)
        f = cfg["moe_intermediate_size"]
        moe = torch.zeros_like(x)
        for e in range(E):
            tok, slot = torch.nonzero(top_e == e, as_tuple=True)
            if tok.numel() == 0:
                continue
            gu = r(h[tok]) @ r(w[p + "w_gate_up"][e].float())
            a = F.silu(gu[:, :f]) * gu[:, f:]
            moe.index_add_(0, tok, (r(a) @ r(w[p + "w_down"][e].float())) * top_w[tok, slot, None])
        x = x + moe
    return _rms(x, w["final_norm"].float(), eps)


def last_logits(weights: Mapping[str, torch.Tensor], cfg: Mapping, history: Sequence[int],
                rounding: Callable[[torch.Tensor], torch.Tensor] = _exact) -> torch.Tensor:
    """(vocab,) f32 logits of the item after ``history``: the head at
    the last position."""
    h = hidden(weights, cfg, history, rounding)[-1]
    return rounding(h) @ rounding(weights["head"].float())
