"""The plain reference of the sessionrec model's serving answer: one
query's next-item scores, in float32, from the weights and the history
alone.

A pre-LayerNorm causal transformer (SASRec family, arXiv:1808.09781, as
the repository defines it): item and position embeddings; per block
``x + attn(LN1(x))·W_o`` then ``x + gelu_tanh(LN2(x)·W_1 + b_1)·W_2 +
b_2``; a final LayerNorm; scores of the last real position against the
tied item table. LayerNorm takes the population variance with eps 1e-6
inside the square root; GELU is the tanh form; attention is softmax over
the causal keys scaled by 1/sqrt(head dim). The history is run at its
own length, so no padding and no key mask enter: under a causal mask
the padded keys of a right-padded batch never reach a real position.

Scores of PAD (id 0) and of the history's own items are -inf: a served
item is never one of them. TF32 is switched off, so float32 products
are float32. ``rounding`` (``reference/lowp.py``) rounds every product
operand, for the control. Imports torch only.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.lowp import exact


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * g + b


def scores(weights: Mapping[str, torch.Tensor], cfg: Mapping, history: np.ndarray,
           rounding: Callable[[torch.Tensor], torch.Tensor] = exact) -> torch.Tensor:
    """(vocab,) f32 scores of the item after ``history`` (its latest
    ``max_len`` items), PAD and the history's items at -inf."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = rounding
    w = weights
    dev = w["item_emb"].device
    d, H = cfg["d_model"], cfg["n_heads"]
    dh = d // H
    seq = torch.as_tensor(np.asarray(history[-cfg["max_len"]:], dtype=np.int64), device=dev)
    L = seq.shape[0]
    x = w["item_emb"][seq].float() + w["pos_emb"][:L].float()
    causal = torch.ones((L, L), dtype=torch.bool, device=dev).tril()
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        h = _ln(x, w[p + "ln1.g"], w[p + "ln1.b"])
        q, k, v = (r(h) @ r(w[p + "wqkv"])).split(d, dim=-1)
        q, k, v = (t.reshape(L, H, dh).transpose(0, 1) for t in (q, k, v))   # (H, L, dh)
        logits = (r(q) @ r(k).transpose(1, 2)) / math.sqrt(dh)
        att = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=-1)
        o = (r(att) @ r(v)).transpose(0, 1).reshape(L, d)
        x = x + r(o) @ r(w[p + "wo"])
        h = _ln(x, w[p + "ln2.g"], w[p + "ln2.b"])
        m = F.gelu(r(h) @ r(w[p + "w1"]) + w[p + "b1"], approximate="tanh")
        x = x + r(m) @ r(w[p + "w2"]) + w[p + "b2"]
    last = _ln(x[-1], w["out_ln.g"], w["out_ln.b"])
    out = r(w["item_emb"].float()) @ r(last)
    out[0] = float("-inf")
    out[seq] = float("-inf")
    return out
