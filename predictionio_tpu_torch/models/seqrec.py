"""Self-attentive sequential recommendation (SASRec-family): the port of
the JAX package's ``models/seqrec.py``: serving, and training on one
device or over a device mesh.

``SeqRec`` computes the JAX ``forward``, with the JAX package's numerics
kept op by op (autograd differentiates through every cast, as JAX does):

- parameters are f32 and are cast to ``cfg.dtype`` (bf16 by default) at
  each op; the embedding gather is cast, and the positional add and the
  padding-mask multiply happen in ``cfg.dtype``;
- weights keep the JAX layout (in, out) and are applied as ``x @ W``;
- LayerNorm computes in f32 with the population variance and eps 1e-6
  inside the rsqrt, then casts back (``nn.LayerNorm`` differs);
- GELU is the tanh approximation (``jax.nn.gelu``'s default);
- attention at inference goes through ``ops/flash_attention``: the
  CUDA kernel on the card, its plain version on the CPU. Training takes
  the differentiable routes of ``ops/attention.py``:
  ``blockwise_attention(q_block=128)`` for S >= 4096 with S % 128 == 0,
  else ``full_attention``. No training path reaches the flash kernel;
- the logits against the tied item table take bf16-rounded operands and
  accumulate in f32 (JAX's ``preferred_element_type=f32``).

Training is ``train``: Adam steps (``make_train_step``) over
``next_item_loss`` in the JAX package's data order, with the mid-training
checkpoint (params, both moments, epoch and step in one atomic file).

Over a mesh (``mesh=``, JAX's batch spec ``P("data", "seq")``) each
position runs the model on its (data, seq) block of the batch with the
parameters replicated, one copy per distinct device (:func:`forward_mesh`);
where the mesh's "seq" axis is > 1 attention is ring attention over it
(``ops/attention.ring_attention_sharded``) and the loss is not tiled. The
loss is the global masked mean, the gradients are summed over devices
and processes before the Adam update, so every replica takes the same
step. Of an axis the batch is not split over ("model") only index 0
runs (:func:`batch_mesh`); its other positions do no work.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import logging
import math
import os
import time
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from predictionio_tpu_torch.obs.trace import span
from predictionio_tpu_torch.ops.attention import (
    blockwise_attention,
    full_attention,
    ring_attention_sharded,
)
from predictionio_tpu_torch.ops.flash_attention import flash_attention
from predictionio_tpu_torch.ops.topk import topk_lowest_index
from predictionio_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    ShardedArray,
    axis_index,
    device_put,
    local_map,
    process_sum,
)
from predictionio_tpu_torch.utils.device import ieee_f32, resolve_device

logger = logging.getLogger(__name__)

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
    #: recompute each block in the backward pass (torch.utils.checkpoint)
    #: instead of keeping its activations: memory, not values
    remat: bool = False

    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        out["dtype"] = str(self.dtype).removeprefix("torch.")
        return out

    @staticmethod
    def from_json(obj: Mapping[str, Any]) -> "SeqRecConfig":
        """From :meth:`to_json`'s dict, or from the fields of the JAX
        package's config, whose dtype may be any object numpy names
        ("bfloat16"); fields the port lacks (``dropout``, which has no
        effect there either) are dropped."""
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

    def heads(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The attention's inputs: q, k, v as (B, H, S, D/H)."""
        B, S, d = x.shape
        H = self.cfg.n_heads
        hpre = self.ln1(x)
        q, k, v = (hpre @ self.wqkv.to(self.cfg.dtype)).split(d, dim=-1)   # (B, S, D) each

        def split(t):
            return t.reshape(B, S, H, d // H).transpose(1, 2).contiguous()

        return split(q), split(k), split(v)

    def finish(self, x: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
        """The rest of the block after attention: output projection,
        residual, LayerNorm, MLP."""
        B, S, d = x.shape
        dt = self.cfg.dtype
        x = x + att.transpose(1, 2).reshape(B, S, d) @ self.wo.to(dt)
        hpre = self.ln2(x)
        hmid = F.gelu(hpre @ self.w1.to(dt) + self.b1.to(dt), approximate="tanh")
        return x + hmid @ self.w2.to(dt) + self.b2.to(dt)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                attention: Callable) -> torch.Tensor:
        q, k, v = self.heads(x)
        return self.finish(x, attention(q, k, v, causal=True, kv_mask=mask))


def train_attention(seq_len: int) -> Callable:
    """The JAX package's single-device training route: blockwise
    attention with 128-query tiles where full attention's (S, S) logits
    grow large, full attention otherwise."""
    if seq_len >= 4096 and seq_len % 128 == 0:
        return functools.partial(blockwise_attention, q_block=128)
    return full_attention


class SeqRec(nn.Module):
    """Causal transformer over right-padded item sequences; ``forward``
    returns the hidden states (B, S, D) in ``cfg.dtype``. Its parameters
    are frozen (serving); ``model.requires_grad_()`` makes them trainable,
    as :func:`make_train_step` does."""

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

    def forward(self, seqs: torch.Tensor, attention: Callable | None = None, *,
                inference: bool = True, real_tokens: int | None = None) -> torch.Tensor:
        """``seqs`` (B, S) item ids right-padded with PAD. ``attention``
        defaults to ``flash_attention`` for inference and to
        :func:`train_attention`'s route otherwise; any function with
        their signature may stand in (the card-side checks pass the plain
        versions). ``real_tokens`` is not read: a dense model computes
        every position (``models/moe_seqrec.py`` sizes its expert
        dispatch by it)."""
        S = seqs.shape[1]
        if attention is None:
            attention = flash_attention if inference else train_attention(S)
        dt = self.cfg.dtype
        mask = (seqs != PAD).float()                               # (B, S)
        x = self.item_emb[seqs].to(dt)
        x = x + self.pos_emb[:S].to(dt)
        x = x * mask[..., None].to(dt)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, mask, attention, use_reentrant=False)
            else:
                x = layer(x, mask, attention)
        return self.out_ln(x)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Scores (..., V) in f32 of final hidden states ``h``
        (:func:`logits_from_hidden`, the tied item table)."""
        return logits_from_hidden(self, h)


def _seq_sharded(mesh: Mesh | None, seq_axis: str = "seq") -> bool:
    return mesh is not None and mesh.axis_size(seq_axis) > 1


def batch_spec(mesh: Mesh, seq_axis: str = "seq") -> tuple[str | None, str | None]:
    """How a (B, S) batch lies on ``mesh``: rows over "data", positions
    over ``seq_axis`` where the mesh has them (JAX's ``P("data", "seq")``)."""
    return ("data" if "data" in mesh.axis_names else None,
            seq_axis if seq_axis in mesh.axis_names else None)


def batch_mesh(mesh: Mesh, seq_axis: str = "seq") -> Mesh | None:
    """The positions of ``mesh`` that run seqrec: its section over "data"
    and ``seq_axis`` (:meth:`Mesh.section`). An axis seqrec does not use,
    such as "model", stands at index 0, and its other positions do no
    work. ``None`` where this rank owns none of them."""
    return mesh.section(a for a in batch_spec(mesh, seq_axis) if a is not None)


def replicas(model: SeqRec, mesh: Mesh) -> dict[torch.device, SeqRec]:
    """One replica for each device of the mesh's local positions:
    ``model`` on its own device, a copy of it on each other (the
    parameters replicated, one copy per distinct device)."""
    out = {}
    for pos in mesh.local_positions:
        dev = mesh.device(pos)
        if dev not in out:
            if dev == model.device:
                out[dev] = model
                continue
            copy = SeqRec(model.cfg, dev)
            copy.load_state_dict(model.state_dict())
            out[dev] = copy.requires_grad_(model.item_emb.requires_grad)
    return out


def forward_mesh(model: SeqRec | Mapping[torch.device, SeqRec], seqs: ShardedArray, mesh: Mesh,
                 *, seq_axis: str = "seq", inference: bool = False,
                 attention: Callable | None = None) -> ShardedArray:
    """JAX's ``forward(params, seqs, cfg, mesh)``: hidden states (B, S, D)
    laid out as ``seqs`` (:func:`batch_spec`), each position running its
    block on its device's replica (``model``, or a mapping of them from
    :func:`replicas`). Where ``seq_axis`` is > 1 each block's position
    embeddings start at its offset ``idx · S/n`` and attention is ring
    attention over the axis (before ``inference``, as in JAX); else each
    position runs :meth:`SeqRec.forward` on its rows."""
    at = model if isinstance(model, Mapping) else replicas(model, mesh)

    def mdl(pos) -> SeqRec:
        return at[mesh.device(pos)]

    spec = tuple(seqs.spec) + (None,)
    if not _seq_sharded(mesh, seq_axis):
        return local_map(mesh, lambda pos, s: mdl(pos)(s, attention, inference=inference),
                         seqs, spec=spec, with_pos=True)
    cfg = next(iter(at.values())).cfg
    dt = cfg.dtype
    Sl = seqs.shards[0].shape[1]

    def embed(pos, s):
        m = mdl(pos)
        start = axis_index(mesh, pos, seq_axis) * Sl
        mask = (s != PAD).float()                                  # (b, Sl)
        x = m.item_emb[s].to(dt)
        x = x + m.pos_emb[start:start + Sl].to(dt)
        return x * mask[..., None].to(dt), mask

    x, mask = local_map(mesh, embed, seqs, spec=spec, with_pos=True)
    spec4 = (spec[0], None, spec[1], None)

    def block(i: int, x: ShardedArray, mask: ShardedArray) -> ShardedArray:
        q, k, v = local_map(mesh, lambda pos, x_: mdl(pos).layers[i].heads(x_), x,
                            spec=spec4, with_pos=True)
        att = ring_attention_sharded(q, k, v, mask, seq_axis=seq_axis, causal=True)
        return local_map(mesh, lambda pos, x_, a: mdl(pos).layers[i].finish(x_, a), x, att,
                         spec=spec, with_pos=True)

    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        if remat:
            n = len(x.shards)

            def run(*shards, i=i):
                return block(i, ShardedArray(mesh, spec, shards[:n]),
                             ShardedArray(mesh, spec[:2], shards[n:])).shards

            x = ShardedArray(mesh, spec, tuple(checkpoint(run, *x.shards, *mask.shards,
                                                          use_reentrant=False)))
        else:
            x = block(i, x, mask)
    return local_map(mesh, lambda pos, x_: mdl(pos).out_ln(x_), x, spec=spec, with_pos=True)


class _IeeeTiedLogits(torch.autograd.Function):
    """``h @ w.T`` whose forward and backward products both run in true
    f32 (``ieee_f32``): TF32 would keep 10 mantissa bits, and the
    process's own TF32 setting is left as the caller had it."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(h, w)
        with ieee_f32():
            return h @ w.T

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        h, w = ctx.saved_tensors
        grad_h = grad_w = None
        with ieee_f32():
            if ctx.needs_input_grad[0]:
                grad_h = grad @ w
            if ctx.needs_input_grad[1]:
                grad_w = grad.reshape(-1, grad.shape[-1]).T @ h.reshape(-1, h.shape[-1])
        return grad_h, grad_w


def logits_from_hidden(model: SeqRec, h: torch.Tensor) -> torch.Tensor:
    """Tied-weight output projection (..., V) in f32: operands rounded to
    h's dtype, products accumulated in f32, in the forward and the
    backward pass."""
    return _IeeeTiedLogits.apply(h.float(), model.item_emb.to(h.dtype).float())


@torch.inference_mode()
def predict_topk_batch(
    model: SeqRec, history: torch.Tensor, k: int, vocab_masks: torch.Tensor,
    *, attention: Callable | None = None, real_tokens: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k next items (scores, ids) for (B, S) right-padded histories,
    with a per-query additive logit mask ``vocab_masks`` (B, V): 0 for
    allowed ids, a large negative for pad/seen/black-listed ones.
    ``model`` is a ``SeqRec`` or a ``models/moe_seqrec.MoESeqRec``: its
    forward gives the hidden states and its ``logits`` the scores;
    ``real_tokens`` (at least the real positions, where the caller knows
    it on the host) goes to the forward.

    Stage spans: ``seqrec.copy_in`` (the histories to the device: empty
    when the caller built them there, as the sessionrec template does;
    from pageable host memory the host waits for the copy),
    ``seqrec.forward`` (the model, the last real position, the logits,
    the mask's add, after its copy to the device when it is not there
    yet) and ``seqrec.topk``."""
    with span("seqrec.copy_in"):
        history = history.to(model.device)
    with span("seqrec.forward"):
        mask = history != PAD
        last = (mask.sum(dim=1) - 1).clamp_min(0)
        h = model(history, attention=attention, real_tokens=real_tokens)
        hl = h[torch.arange(h.shape[0], device=h.device), last]         # (B, D)
        logits = model.logits(hl) + vocab_masks.to(model.device)
    with span("seqrec.topk"):
        return topk_lowest_index(logits, k)


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


# ---------------------------------------------------------------------------
# Training: loss, Adam, the epoch loop and its mid-training checkpoint
# ---------------------------------------------------------------------------

#: flat-path budget for the (B, S, V) f32 logits, the JAX package's: above
#: it the loss runs in sequence tiles that the backward pass recomputes
#: (an out-of-memory guard, not a default; the recompute costs time)
_LOSS_TILE_BYTES = 4 << 30


def _pick_loss_tile(b: int, s: int, v: int) -> int | None:
    """Largest divisor of ``s`` whose (b, T, v) f32 logits fit the tile
    budget; None when even the flat path fits (no tiling needed)."""
    if b * s * v * 4 <= _LOSS_TILE_BYTES:
        return None
    for t in (128, 64, 32, 16, 8, 4, 2, 1):
        if s % t == 0 and b * t * v * 4 <= _LOSS_TILE_BYTES:
            return t
    return 1


def _masked_nll_sum(model: SeqRec, h: torch.Tensor, targets: torch.Tensor,
                    tmask: torch.Tensor) -> torch.Tensor:
    logits = logits_from_hidden(model, h)                          # (B, T, V) f32
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    return (nll * tmask).sum()


def next_item_loss(model: SeqRec, seqs, targets, *,
                   attention: Callable | None = None, mesh: Mesh | None = None,
                   at: Mapping[torch.device, SeqRec] | None = None) -> torch.Tensor:
    """Mean masked softmax cross-entropy of next-item prediction over
    (B, S) int64 ``seqs`` and ``targets`` (PAD targets are ignored).
    ``attention`` overrides the training route (the card-side check
    forces ``full_attention`` against the blockwise route). Where the
    f32 logits exceed ``_LOSS_TILE_BYTES`` the loss runs in sequence
    tiles, each under ``torch.utils.checkpoint``.

    Over ``mesh`` (``seqs``/``targets`` whole tensors; ``at`` the
    replicas of :func:`batch_mesh`'s positions, default
    :func:`replicas`) the sum runs block by block on those positions,
    untiled where "seq" is sharded, the tile picked for the global batch
    otherwise, as in JAX. The value is the global loss; across processes
    its gradient is this rank's part, which the train step sums over the
    ranks."""
    if mesh is not None:
        return _mesh_loss(model, mesh, seqs, targets, attention, at)
    h = model(seqs, attention, inference=False)
    B, S, _ = h.shape
    tile = _pick_loss_tile(B, S, model.cfg.vocab)
    tmask = (targets != PAD).float()
    count = tmask.sum().clamp_min(1.0)
    return _nll_sum(model, h, targets, tmask, tile) / count


def _nll_sum(model: SeqRec, h: torch.Tensor, targets: torch.Tensor, tmask: torch.Tensor,
             tile: int | None) -> torch.Tensor:
    if tile is None:
        return _masked_nll_sum(model, h, targets, tmask)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for s in range(0, h.shape[1], tile):
        total = total + checkpoint(_masked_nll_sum, model, h[:, s:s + tile],
                                   targets[:, s:s + tile], tmask[:, s:s + tile],
                                   use_reentrant=False)
    return total


def _mesh_loss(model: SeqRec, mesh: Mesh, seqs: torch.Tensor, targets: torch.Tensor,
               attention: Callable | None, at: Mapping[torch.device, SeqRec] | None
               ) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.float32, device=model.device)
    count = torch.zeros((), dtype=torch.float32, device=model.device)
    sub = batch_mesh(mesh)
    if sub is not None:     # each (data, seq) block once
        at = replicas(model, sub) if at is None else at
        spec = batch_spec(sub)
        seqs, targets = (device_put(x, NamedSharding(sub, spec)) for x in (seqs, targets))
        h = forward_mesh(at, seqs, sub, attention=attention)
        B, S = seqs.shape
        tile = None if _seq_sharded(sub) else _pick_loss_tile(B, S, model.cfg.vocab)
        sums = local_map(sub, lambda pos, h_, t_: _nll_sum(
            at[sub.device(pos)], h_, t_, (t_ != PAD).float(), tile), h, targets, with_pos=True)
        counts = local_map(sub, lambda t_: (t_ != PAD).float().sum(), targets)
        for p in sub.local_positions:
            total = total + sums.local(p).to(model.device)
            count = count + counts.local(p).to(model.device)
    every_total, every_count = process_sum(mesh, [total.detach(), count])
    count = every_count.clamp_min(1.0)
    part = total / count
    return part + (every_total / count - part).detach()


def _adam_update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                 m: Sequence[torch.Tensor], v: Sequence[torch.Tensor], step: int,
                 lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """Adam in place, in the JAX package's order of operations:
    m = b1·m + (1-b1)·g; v = b2·v + (1-b2)·g·g;
    p -= lr·(m/bc1) / (sqrt(v/bc2) + eps), with the bias corrections
    1 - b**step computed in f32 as the jitted JAX step computes them."""
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(grads, 1 - b1))
    g2 = torch._foreach_mul(grads, 1 - b2)
    torch._foreach_mul_(g2, grads)
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, g2)
    f32 = np.float32
    bc1 = float(f32(1) - f32(b1) ** f32(step))
    bc2 = float(f32(1) - f32(b2) ** f32(step))
    update = torch._foreach_div(m, bc1)
    torch._foreach_mul_(update, lr)
    denom = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(update, denom)
    torch._foreach_sub_(list(params), update)


def adam_state(model: SeqRec) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Zero first and second moments, one per parameter of ``model``."""
    return ([torch.zeros_like(p) for p in model.parameters()],
            [torch.zeros_like(p) for p in model.parameters()])


def make_train_step(model: SeqRec, *, attention: Callable | None = None,
                    mesh: Mesh | None = None) -> Callable:
    """One Adam step on ``model``'s parameters, in place, on its device:
    ``step(opt_m, opt_v, it, seqs, targets, lr) -> loss`` (a 0-d device
    tensor), with the moments of :func:`adam_state` and ``it`` the
    1-based global step that the bias correction reads. Makes the
    model's parameters trainable.

    Over ``mesh`` the batch is laid out by :func:`batch_spec` on the
    positions of :func:`batch_mesh`, each of their devices holds a
    replica, the gradients are summed over the replicas and the
    processes, and every replica takes ``model``'s Adam step. A rank
    that holds none of those positions adds zeros and takes the step."""
    params = list(model.requires_grad_().parameters())
    sub = batch_mesh(mesh) if mesh is not None else None
    at = replicas(model, sub) if sub is not None else {}
    copies = [r for r in at.values() if r is not model]

    def step(opt_m, opt_v, it: int, seqs: torch.Tensor, targets: torch.Tensor,
             lr: float) -> torch.Tensor:
        for r in (model, *copies):
            for p in r.parameters():
                p.grad = None
        loss = next_item_loss(model, seqs, targets, attention=attention, mesh=mesh, at=at)
        if loss.requires_grad:      # not where this rank runs no block
            loss.backward()
        with torch.no_grad():
            if mesh is None:
                grads = [p.grad for p in params]
            else:
                grads = [torch.zeros_like(p) for p in params]
                for r in at.values():
                    for g, q in zip(grads, r.parameters()):
                        g += q.grad.to(g.device)
                grads = process_sum(mesh, grads)
            _adam_update(params, grads, opt_m, opt_v, it, lr)
            for r in copies:
                for q, p in zip(r.parameters(), params):
                    q.copy_(p)
        return loss.detach()

    return step


@dataclasses.dataclass
class TrainRun:
    """What :func:`train` returns."""

    params: dict[str, torch.Tensor]    # f32 state dict on the host
    #: one per Adam step of this call, in order
    losses: list[float] = dataclasses.field(default_factory=list)
    #: host seconds per step, ending when its loss reaches the host (which
    #: waits for the device)
    step_seconds: list[float] = dataclasses.field(default_factory=list)


def train(
    sequences: list[list[int]],
    cfg: SeqRecConfig,
    *,
    epochs: int = 20,
    batch_size: int = 64,
    lr: float = 1e-3,
    seed: int = 0,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    initial: Mapping[str, torch.Tensor] | None = None,
    device: str | torch.device | None = None,
    mesh: Mesh | None = None,
) -> TrainRun:
    """Adam over dense-indexed item sequences (ids >= 1), on ``device``
    (default ``cuda``), in the JAX package's data order: every step takes
    a static batch of ``min(batch_size, n)`` rows, the set padded with
    all-PAD rows to a multiple of it, in the order of
    ``np.random.default_rng(seed).permutation`` drawn once per epoch.

    ``initial`` is the starting state dict (default: :func:`init_params`
    from ``seed``; the tests pass the JAX package's draw). Over ``mesh``
    (on its home device; ``device`` is then not read) the batch is rounded
    down to a multiple of the "data" axis, at least one row a position,
    as in JAX, and each step runs over the mesh (:func:`make_train_step`).
    With
    ``checkpoint_dir`` and ``checkpoint_every`` N the parameters, both
    Adam moments, the epoch and the step count are written every N
    epochs by one atomic replace, and a later call with the same config,
    data, lr and seed resumes after the last one; any other call starts
    fresh, with a warning."""
    dev = mesh.device(mesh.home) if mesh is not None else resolve_device(device)
    inputs, targets = pad_sequences(sequences, cfg.max_len)
    n = inputs.shape[0]
    # identity from the arrays before batch padding, as in the JAX package
    fingerprint = _train_fingerprint(cfg, inputs, targets, lr, seed) if checkpoint_dir else None
    bs = min(batch_size, n)
    if mesh is not None:
        mult = mesh.axis_size("data")
        bs = max(mult, (bs // mult) * mult)
    pad_rows = (-n) % bs
    if pad_rows:
        inputs = np.concatenate([inputs, np.zeros((pad_rows, cfg.max_len), np.int32)])
        targets = np.concatenate([targets, np.zeros((pad_rows, cfg.max_len), np.int32)])
        n = inputs.shape[0]

    model = SeqRec(cfg, dev)
    model.load_state_dict(dict(initial if initial is not None else
                               init_params(cfg, torch.Generator().manual_seed(seed))))
    opt_m, opt_v = adam_state(model)
    start_epoch, it = 0, 0
    if checkpoint_dir:
        resumed = _load_train_state(checkpoint_dir, model, fingerprint)
        if resumed is not None:
            opt_m, opt_v, start_epoch, it = resumed
            logger.info("seqrec: resumed from %s at epoch %d", checkpoint_dir, start_epoch)
            if start_epoch >= epochs:
                logger.warning("seqrec: checkpoint already at epoch %d >= requested epochs "
                               "%d; returning its weights with no further training",
                               start_epoch, epochs)
    step = make_train_step(model, mesh=mesh)

    run = TrainRun(params={})
    rng = np.random.default_rng(seed)
    for epoch in range(epochs):
        if epoch < start_epoch:
            rng.permutation(n)  # keep the data order stream aligned
            continue
        order = rng.permutation(n)
        for s in range(0, n, bs):
            idx = order[s:s + bs]
            it += 1
            t0 = time.perf_counter()
            loss = step(opt_m, opt_v, it,
                        torch.from_numpy(inputs[idx]).to(dev, torch.long),
                        torch.from_numpy(targets[idx]).to(dev, torch.long), lr)
            run.losses.append(loss.item())
            run.step_seconds.append(time.perf_counter() - t0)
        if epoch == 0 or (epoch + 1) % 5 == 0:
            logger.info("seqrec epoch %d loss %.4f", epoch + 1,
                        float(np.mean(run.losses[-(n // bs):])))
        if checkpoint_dir and checkpoint_every and (epoch + 1) % checkpoint_every == 0:
            _save_train_state(checkpoint_dir, model, opt_m, opt_v, epoch + 1, it, fingerprint)
    run.params = {k: t.detach().cpu() for k, t in model.state_dict().items()}
    return run


def _train_fingerprint(cfg: SeqRecConfig, inputs: np.ndarray, targets: np.ndarray,
                       lr: float, seed: int) -> str:
    """Identity of a training run: the config, the exact dataset, lr and
    seed. A checkpoint resumes only a run with the same fingerprint."""
    h = hashlib.sha1()
    h.update(json.dumps(cfg.to_json(), sort_keys=True).encode())
    h.update(np.ascontiguousarray(inputs).tobytes())
    h.update(np.ascontiguousarray(targets).tobytes())
    h.update(np.float64(lr).tobytes())  # pio: lint-ignore[dtype-discipline]: checkpoint-identity serialization — 8 stable bytes, never a compute dtype
    h.update(np.int64(seed).tobytes())
    return h.hexdigest()


def _save_train_state(directory: str, model: SeqRec, opt_m, opt_v, epoch: int, it: int,
                      fingerprint: str) -> None:
    os.makedirs(directory, exist_ok=True)
    arrays = {"__epoch__": np.int64(epoch), "__it__": np.int64(it),
              "__fingerprint__": np.bytes_(fingerprint.encode())}
    for (name, p), m, v in zip(model.named_parameters(), opt_m, opt_v):
        arrays["p" + name] = p.detach().cpu().numpy()
        arrays["m" + name] = m.cpu().numpy()
        arrays["v" + name] = v.cpu().numpy()
    tmp = os.path.join(directory, ".train_state.npz.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    # one atomic replace covers params, moments and counters together
    os.replace(tmp, os.path.join(directory, "train_state.npz"))


def _load_train_state(directory: str, model: SeqRec, fingerprint: str):
    """(opt_m, opt_v, epoch, it), with the saved parameters copied into
    ``model``; None when there is no checkpoint or it is another run's."""
    path = os.path.join(directory, "train_state.npz")
    if not os.path.exists(path):
        return None
    named = list(model.named_parameters())
    with np.load(path) as data:
        same = (bytes(data["__fingerprint__"]).decode() == fingerprint and all(
            f"{kind}{name}" in data.files and data[f"{kind}{name}"].shape == tuple(p.shape)
            for name, p in named for kind in "pmv"))
        if not same:
            logger.warning("seqrec: checkpoint at %s is from a different run (config, "
                           "dataset, lr or seed changed); starting fresh", directory)
            return None

        def load(kind: str) -> list[torch.Tensor]:
            return [torch.from_numpy(data[kind + name]).to(p.device) for name, p in named]

        with torch.no_grad():
            for p, saved in zip(model.parameters(), load("p")):
                p.copy_(saved)
        return load("m"), load("v"), int(data["__epoch__"]), int(data["__it__"])
