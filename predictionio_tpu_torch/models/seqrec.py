"""Self-attentive sequential recommendation (SASRec-family): the serving
half of the JAX package's ``models/seqrec.py``.

``SeqRec`` computes the inference forward of the JAX ``forward``, with
the JAX package's numerics kept op by op:

- parameters are f32 and are cast to ``cfg.dtype`` (bf16 by default) at
  each op; the embedding gather is cast, and the positional add and the
  padding-mask multiply happen in ``cfg.dtype``;
- weights keep the JAX layout (in, out) and are applied as ``x @ W``;
- LayerNorm computes in f32 with the population variance and eps 1e-6
  inside the rsqrt, then casts back (``nn.LayerNorm`` differs);
- GELU is the tanh approximation (``jax.nn.gelu``'s default);
- attention goes through ``ops/flash_attention.flash_attention``: the
  CUDA kernel on the card, its plain version on the CPU;
- the logits against the tied item table take bf16-rounded operands and
  accumulate in f32 (JAX's ``preferred_element_type=f32``).

Training (``next_item_loss``, Adam, blockwise attention) comes in a
later slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from predictionio_tpu_torch.ops.flash_attention import flash_attention
from predictionio_tpu_torch.utils.device import resolve_device

PAD = 0  # item id 0 is reserved for padding; real ids start at 1

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class SeqRecConfig:
    vocab: int              # number of items + 1 (pad)
    max_len: int = 64
    d_model: int = 64
    n_heads: int = 2
    n_layers: int = 2
    mlp_mult: int = 4
    dtype: torch.dtype = torch.bfloat16

    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        out["dtype"] = str(self.dtype).removeprefix("torch.")
        return out

    @staticmethod
    def from_json(obj: Mapping[str, Any]) -> "SeqRecConfig":
        """From :meth:`to_json`'s dict, or from the fields of the JAX
        package's config, whose training-only fields are dropped and
        whose dtype may be any object numpy names ("bfloat16")."""
        names = {f.name for f in dataclasses.fields(SeqRecConfig)}
        kw = {k: v for k, v in obj.items() if k in names}
        dt = kw.get("dtype", "bfloat16")
        kw["dtype"] = dt if isinstance(dt, torch.dtype) else \
            DTYPES[dt if isinstance(dt, str) else np.dtype(dt).name]
        return SeqRecConfig(**kw)


def init_params(cfg: SeqRecConfig, generator: torch.Generator | None = None
                ) -> dict[str, torch.Tensor]:
    """f32 state dict on the host, drawn as the JAX ``init_params`` draws
    (the numbers differ: torch and jax.random are different generators)."""
    d, h = cfg.d_model, cfg.mlp_mult * cfg.d_model

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    state = {
        "item_emb": normal(cfg.vocab, d) / math.sqrt(d),
        "pos_emb": normal(cfg.max_len, d) / math.sqrt(d),
        "out_ln.g": torch.ones(d),
        "out_ln.b": torch.zeros(d),
    }
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        state.update({
            p + "ln1.g": torch.ones(d), p + "ln1.b": torch.zeros(d),
            p + "ln2.g": torch.ones(d), p + "ln2.b": torch.zeros(d),
            p + "wqkv": normal(d, 3 * d) / math.sqrt(d),
            p + "wo": normal(d, d) / math.sqrt(d),
            p + "w1": normal(d, h) / math.sqrt(d),
            p + "b1": torch.zeros(h),
            p + "w2": normal(h, d) / math.sqrt(h),
            p + "b2": torch.zeros(d),
        })
    return state


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """The JAX parameter pytree (as numpy arrays: ``item_emb``,
    ``pos_emb``, ``out_ln``, ``layers[i]`` with ``ln1``, ``ln2``,
    ``wqkv``, ``wo``, ``w1``, ``b1``, ``w2``, ``b2``) as this module's
    f32 state dict. Weights keep their (in, out) layout."""
    def t(x):
        return torch.tensor(np.asarray(x, dtype=np.float32))

    state = {
        "item_emb": t(tree["item_emb"]),
        "pos_emb": t(tree["pos_emb"]),
        "out_ln.g": t(tree["out_ln"]["g"]),
        "out_ln.b": t(tree["out_ln"]["b"]),
    }
    for i, layer in enumerate(tree["layers"]):
        p = f"layers.{i}."
        for ln in ("ln1", "ln2"):
            state[p + ln + ".g"] = t(layer[ln]["g"])
            state[p + ln + ".b"] = t(layer[ln]["b"])
        for name in ("wqkv", "wo", "w1", "b1", "w2", "b2"):
            state[p + name] = t(layer[name])
    return state


class LayerNorm(nn.Module):
    """The JAX ``_ln``: f32 statistics, population variance, eps 1e-6
    inside the rsqrt, cast back to the input dtype."""

    def __init__(self, d: int, device: torch.device):
        super().__init__()
        self.g = nn.Parameter(torch.ones(d, device=device), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(d, device=device), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mu = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, correction=0)
        return ((x32 - mu) * torch.rsqrt(var + 1e-6) * self.g + self.b).to(x.dtype)


class _Block(nn.Module):
    def __init__(self, cfg: SeqRecConfig, device: torch.device):
        super().__init__()
        d, h = cfg.d_model, cfg.mlp_mult * cfg.d_model
        self.cfg = cfg
        self.ln1 = LayerNorm(d, device)
        self.ln2 = LayerNorm(d, device)

        def param(*shape):
            return nn.Parameter(torch.zeros(shape, device=device), requires_grad=False)

        self.wqkv, self.wo = param(d, 3 * d), param(d, d)
        self.w1, self.b1 = param(d, h), param(h)
        self.w2, self.b2 = param(h, d), param(d)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                attention: Callable) -> torch.Tensor:
        B, S, d = x.shape
        H = self.cfg.n_heads
        dt = self.cfg.dtype
        hpre = self.ln1(x)
        q, k, v = (hpre @ self.wqkv.to(dt)).split(d, dim=-1)   # (B, S, D) each

        def heads(t):
            return t.reshape(B, S, H, d // H).transpose(1, 2).contiguous()

        att = attention(heads(q), heads(k), heads(v), causal=True, kv_mask=mask)
        x = x + att.transpose(1, 2).reshape(B, S, d) @ self.wo.to(dt)

        hpre = self.ln2(x)
        hmid = F.gelu(hpre @ self.w1.to(dt) + self.b1.to(dt), approximate="tanh")
        return x + hmid @ self.w2.to(dt) + self.b2.to(dt)


class SeqRec(nn.Module):
    """Causal transformer over right-padded item sequences; ``forward``
    returns the hidden states (B, S, D) in ``cfg.dtype``."""

    def __init__(self, cfg: SeqRecConfig, device: str | torch.device | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        d = cfg.d_model
        self.item_emb = nn.Parameter(torch.zeros(cfg.vocab, d, device=dev), requires_grad=False)
        self.pos_emb = nn.Parameter(torch.zeros(cfg.max_len, d, device=dev), requires_grad=False)
        self.layers = nn.ModuleList(_Block(cfg, dev) for _ in range(cfg.n_layers))
        self.out_ln = LayerNorm(d, dev)

    @classmethod
    def from_state(cls, cfg: SeqRecConfig, state: Mapping[str, torch.Tensor],
                   device: str | torch.device | None = None) -> "SeqRec":
        model = cls(cfg, device)
        model.load_state_dict(dict(state))
        return model.eval()

    @property
    def device(self) -> torch.device:
        return self.item_emb.device

    def forward(self, seqs: torch.Tensor, attention: Callable | None = None) -> torch.Tensor:
        """``seqs`` (B, S) item ids right-padded with PAD. ``attention``
        defaults to ``flash_attention``; any function with its signature
        may stand in (the card-side check passes the plain reference)."""
        attention = flash_attention if attention is None else attention
        S = seqs.shape[1]
        dt = self.cfg.dtype
        mask = (seqs != PAD).float()                               # (B, S)
        x = self.item_emb[seqs].to(dt)
        x = x + self.pos_emb[:S].to(dt)
        x = x * mask[..., None].to(dt)
        for layer in self.layers:
            x = layer(x, mask, attention)
        return self.out_ln(x)


def logits_from_hidden(model: SeqRec, h: torch.Tensor) -> torch.Tensor:
    """Tied-weight output projection (..., V) in f32: operands rounded to
    h's dtype, products accumulated in f32."""
    # f32 accumulation means full f32: TF32 would keep 10 mantissa bits
    torch.backends.cuda.matmul.allow_tf32 = False
    return h.float() @ model.item_emb.to(h.dtype).float().T


@torch.inference_mode()
def predict_topk_batch(
    model: SeqRec, history: torch.Tensor, k: int, vocab_masks: torch.Tensor,
    *, attention: Callable | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k next items (scores, ids) for (B, S) right-padded histories,
    with a per-query additive logit mask ``vocab_masks`` (B, V): 0 for
    allowed ids, a large negative for pad/seen/black-listed ones."""
    history = history.to(model.device)
    mask = history != PAD
    last = (mask.sum(dim=1) - 1).clamp_min(0)
    h = model(history, attention=attention)
    hl = h[torch.arange(h.shape[0], device=h.device), last]         # (B, D)
    logits = logits_from_hidden(model, hl) + vocab_masks.to(model.device)
    return torch.topk(logits, k, dim=-1)


def predict_topk(
    model: SeqRec, history: torch.Tensor, k: int, vocab_mask: torch.Tensor,
    *, attention: Callable | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`predict_topk_batch` with one (V,) mask for every row."""
    return predict_topk_batch(model, history, k, vocab_mask[None, :], attention=attention)


def pad_sequences(
    sequences: list[list[int]], max_len: int
) -> tuple[np.ndarray, np.ndarray]:
    """Keep each sequence's most recent max_len+1 items and produce
    (inputs, targets): inputs are seq[:-1] right-padded with PAD,
    targets the shifted next items."""
    B = len(sequences)
    inputs = np.zeros((B, max_len), dtype=np.int32)
    targets = np.zeros((B, max_len), dtype=np.int32)
    for i, seq in enumerate(sequences):
        seq = seq[-(max_len + 1):]
        ins, tgt = seq[:-1], seq[1:]
        inputs[i, : len(ins)] = ins
        targets[i, : len(tgt)] = tgt
    return inputs, targets
