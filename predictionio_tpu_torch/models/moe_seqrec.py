"""A next-item model with a Mellum-class mixture-of-experts decoder block
(grouped-query attention over alternating sliding-window and full
layers, RoPE, RMSNorm, a 64-expert top-8 SwiGLU MoE in every layer) run
over item-id histories: the sessionrec template's second model kind,
beside ``models/seqrec.SeqRec``. Serving only: it is served from given
weights, as ``SeqRecEngineModel.from_jax`` serves JAX-trained ones.

``MoESeqRecConfig`` takes a transformers-style ``config.json``
(``hidden_size``, ``num_attention_heads``, ``num_key_value_heads``,
``head_dim``, ``layer_types``, ``sliding_window``, ``rope_parameters``
per layer type, ``num_experts``, ``num_experts_per_tok``,
``moe_intermediate_size``, ``norm_topk_prob``, ``rms_norm_eps``,
``vocab_size``, ``num_hidden_layers``) plus ``max_len`` (the served
history cap) and ``dtype``. The model runs the first
``num_hidden_layers`` entries of ``layer_types``.

The forward, per layer, on right-padded (B, S) item ids (PAD = 0):

- ``x = item_emb[ids]`` (no position table; positions enter through
  RoPE);
- ``x += o(attn(rope(q), rope(k), v))`` on ``RMSNorm(x)``: q with
  ``num_attention_heads`` heads, k and v with ``num_key_value_heads``
  (GQA), head dim ``head_dim``, scale 1/sqrt(head_dim), causal over the
  real keys, and on ``"sliding_attention"`` layers a window of
  ``sliding_window`` keys (query i sees i - W < j <= i); RoPE tables by
  layer type (``ops/rope.py``: plain or YaRN);
- ``x += moe(RMSNorm(x))`` (``ops/moe.py``), the real positions only;
- after the last layer ``RMSNorm``; the untied head (d, V) scores the
  catalog at the last real position (:meth:`MoESeqRec.logits`).

RMSNorm is transformers' convention: the mean square in f32,
``x·rsqrt(ms + eps)`` rounded to the dtype, then times the gain. Weights
are held in ``dtype`` from load on (no cast at each op: at 2B
parameters a cast per batch would move gigabytes). Attention goes
through ``ops/flash_attention`` (the CUDA kernel's GQA and window routes
on the card, its plain version on the CPU).

Spans (``obs.trace.span``; profiler annotations under a profiler):
``seqrec.attention`` (projections, RoPE, flash, output projection),
``seqrec.moe.route`` (router, top-k, sort, offsets) and
``seqrec.moe.experts`` (grouped products, combine). Counters, on the
device and read only when scraped (:meth:`MoESeqRec.metric_families`,
which the engine server collects from its deployed models):
``routed`` (layers, experts) pairs dispatched to each expert, and
``undispatched`` padded positions the MoE layers left out (summed over
the layers).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import torch
from torch import nn

from predictionio_tpu_torch.obs.registry import Metric
from predictionio_tpu_torch.obs.trace import span
from predictionio_tpu_torch.ops import moe, rope
from predictionio_tpu_torch.ops.flash_attention import flash_attention
from predictionio_tpu_torch.utils.device import resolve_device

PAD = 0
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
SLIDING, FULL = "sliding_attention", "full_attention"


@dataclasses.dataclass(frozen=True)
class MoESeqRecConfig:
    vocab_size: int
    hidden_size: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int
    layer_types: tuple
    sliding_window: int
    rope_parameters: Mapping
    num_experts: int
    num_experts_per_tok: int
    moe_intermediate_size: int
    norm_topk_prob: bool = True
    rms_norm_eps: float = 1e-6
    num_hidden_layers: int | None = None
    max_len: int = 8192
    dtype: torch.dtype = torch.bfloat16

    @property
    def vocab(self) -> int:
        """The sessionrec template's name for the vocabulary size."""
        return self.vocab_size

    @property
    def layers(self) -> tuple:
        """The layer types run: the first ``num_hidden_layers``."""
        n = len(self.layer_types) if self.num_hidden_layers is None else self.num_hidden_layers
        return tuple(self.layer_types[:n])

    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        out["layer_types"] = list(self.layer_types)
        out["rope_parameters"] = {k: dict(v) for k, v in self.rope_parameters.items()}
        out["dtype"] = str(self.dtype).removeprefix("torch.")
        return out

    @staticmethod
    def from_json(obj: Mapping[str, Any]) -> "MoESeqRecConfig":
        """From :meth:`to_json`'s dict or a transformers-style
        ``config.json``; keys the model does not read are dropped. Every
        MLP must be sparse and every layer type known."""
        if any(t != "sparse" for t in obj.get("mlp_layer_types", ())):
            raise ValueError("every layer's MLP must be a sparse MoE")
        names = {f.name for f in dataclasses.fields(MoESeqRecConfig)}
        kw = {k: v for k, v in obj.items() if k in names}
        kw["layer_types"] = tuple(kw["layer_types"])
        unknown = set(kw["layer_types"]) - {SLIDING, FULL}
        if unknown:
            raise ValueError(f"unknown layer types {sorted(unknown)}")
        dt = kw.get("dtype", "bfloat16")
        kw["dtype"] = dt if isinstance(dt, torch.dtype) else DTYPES[dt]
        cfg = MoESeqRecConfig(**kw)
        if len(cfg.layers) < 1 or len(cfg.layers) > len(cfg.layer_types):
            raise ValueError(f"num_hidden_layers {cfg.num_hidden_layers} outside "
                             f"1..{len(cfg.layer_types)}")
        return cfg


def weight_shapes(cfg: MoESeqRecConfig) -> list[tuple[str, tuple[int, ...]]]:
    """(state-dict key, shape) of every weight, in the (in, out) layout."""
    d, V = cfg.hidden_size, cfg.vocab_size
    H, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    E, f = cfg.num_experts, cfg.moe_intermediate_size
    out = [("item_emb", (V, d)), ("final_norm", (d,)), ("head", (d, V))]
    for i in range(len(cfg.layers)):
        p = f"layers.{i}."
        out += [(p + "attn_norm", (d,)), (p + "wqkv", (d, (H + 2 * Hkv) * Dh)),
                (p + "wo", (H * Dh, d)), (p + "moe_norm", (d,)), (p + "router", (d, E)),
                (p + "w_gate_up", (E, d, 2 * f)), (p + "w_down", (E, f, d))]
    return out


def init_params(cfg: MoESeqRecConfig, generator: torch.Generator | None = None
                ) -> dict[str, torch.Tensor]:
    """Random weights on the host in ``cfg.dtype``: matrices normal with
    variance 1/fan-in (the expert stacks per expert), the embedding
    1/hidden, norm gains 1."""
    state = {}
    for name, shape in weight_shapes(cfg):
        if name.endswith("norm"):
            t = torch.ones(shape)
        else:
            fan_in = cfg.hidden_size if name == "item_emb" else shape[-2]
            t = torch.randn(shape, generator=generator) / math.sqrt(fan_in)
        state[name] = t.to(cfg.dtype)
    return state


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    return gain * (x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps)).to(x.dtype)


def _placeholder(cfg: MoESeqRecConfig, *shape: int) -> nn.Parameter:
    """A frozen parameter on the meta device, which holds no memory:
    :meth:`MoESeqRec.from_state` assigns the weights in its place, so a
    model of 24 GB never holds a second, empty copy of itself."""
    return nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device="meta"), requires_grad=False)


class _Block(nn.Module):
    def __init__(self, cfg: MoESeqRecConfig, kind: str):
        super().__init__()
        self.cfg, self.kind = cfg, kind

        shapes = dict(weight_shapes(dataclasses.replace(cfg, num_hidden_layers=1)))
        for name in ("attn_norm", "wqkv", "wo", "moe_norm", "router", "w_gate_up", "w_down"):
            setattr(self, name, _placeholder(cfg, *shapes["layers.0." + name]))

    def attend(self, x: torch.Tensor, key_mask: torch.Tensor, tables, attention: Callable
               ) -> torch.Tensor:
        cfg = self.cfg
        B, S, d = x.shape
        H, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        qkv = rms_norm(x, self.attn_norm, cfg.rms_norm_eps) @ self.wqkv
        q, k, v = qkv.view(B, S, H + 2 * Hkv, Dh).split((H, Hkv, Hkv), dim=2)
        cos, sin = tables
        q = rope.apply(q, cos, sin).transpose(1, 2).contiguous()           # (B, H, S, Dh)
        k = rope.apply(k, cos, sin).transpose(1, 2).contiguous()           # (B, Hkv, S, Dh)
        v = v.transpose(1, 2).contiguous()
        window = cfg.sliding_window if self.kind == SLIDING else None
        att = attention(q, k, v, causal=True, kv_mask=key_mask, window=window)
        return att.transpose(1, 2).reshape(B, S, H * Dh) @ self.wo

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor, tables,
                attention: Callable, capacity: int | None, routed: torch.Tensor
                ) -> torch.Tensor:
        cfg = self.cfg
        B, S, d = x.shape
        with span("seqrec.attention"):
            x = x + self.attend(x, key_mask, tables, attention)
        with span("seqrec.moe.route"):
            h = rms_norm(x, self.moe_norm, cfg.rms_norm_eps).view(B * S, d)
            weights, experts = moe.route(h, self.router, cfg.num_experts_per_tok,
                                         cfg.norm_topk_prob)
            cap = None if capacity is None else capacity * cfg.num_experts_per_tok
            order, counts, offsets = moe.dispatch(experts, key_mask.view(-1) > 0,
                                                  cfg.num_experts, cap)
            routed += counts
        with span("seqrec.moe.experts"):
            y = moe.experts(h, weights, order, offsets, self.w_gate_up, self.w_down)
        return x + y.view(B, S, d)


class MoESeqRec(nn.Module):
    """The model on ``device``; ``forward`` returns the final-normed
    hidden states (B, S, d) in ``cfg.dtype``. Parameters are frozen, and
    placeholders until :meth:`from_state` loads them."""

    def __init__(self, cfg: MoESeqRecConfig, device: str | torch.device | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        d, V = cfg.hidden_size, cfg.vocab_size
        self.item_emb = _placeholder(cfg, V, d)
        self.final_norm = _placeholder(cfg, d)
        self.head = _placeholder(cfg, d, V)
        self.layers = nn.ModuleList(_Block(cfg, kind) for kind in cfg.layers)
        # one cos/sin table per layer type, built once (f32, the max_len rows)
        self._tables = {kind: tuple(t.to(dev) for t in rope.table(
            cfg.rope_parameters[kind], cfg.head_dim, cfg.max_len)) for kind in set(cfg.layers)}
        self.register_buffer("routed", torch.zeros(len(cfg.layers), cfg.num_experts,
                                                   dtype=torch.int64, device=dev),
                             persistent=False)
        self.register_buffer("undispatched", torch.zeros((), dtype=torch.int64, device=dev),
                             persistent=False)

    @classmethod
    def from_state(cls, cfg: MoESeqRecConfig, state: Mapping[str, torch.Tensor],
                   device: str | torch.device | None = None) -> "MoESeqRec":
        """The model over ``state``: tensors already in ``cfg.dtype`` on
        the device are adopted as they are, others copied there."""
        model = cls(cfg, device)
        dev = model.routed.device
        model.load_state_dict({k: v.to(device=dev, dtype=cfg.dtype) for k, v in state.items()},
                              assign=True)
        return model.eval()

    @property
    def device(self) -> torch.device:
        return self.item_emb.device

    def forward(self, seqs: torch.Tensor, attention: Callable | None = None, *,
                real_tokens: int | None = None) -> torch.Tensor:
        """``seqs`` (B, S) item ids right-padded with PAD, S <= max_len.
        ``real_tokens``, where the caller knows it on the host, is at
        least the number of real (non-PAD) positions: the MoE layers then
        allocate pair buffers for those only (``ops/moe.py``)."""
        attention = attention or flash_attention
        key_mask = (seqs != PAD).float()
        # every MoE layer leaves the padded positions out
        self.undispatched += (seqs == PAD).sum() * len(self.layers)
        x = self.item_emb[seqs]
        for i, layer in enumerate(self.layers):
            x = layer(x, key_mask, self._tables[layer.kind], attention, real_tokens,
                      self.routed[i])
        return rms_norm(x, self.final_norm, self.cfg.rms_norm_eps)

    def metric_families(self) -> list[Metric]:
        """The counters as metric families, read from the device (the
        scrape waits for the card; the serving path never reads them):
        ``pio_moe_routed_pairs_total{layer, expert}`` and
        ``pio_moe_undispatched_positions_total``."""
        routed = self.routed.tolist()
        # pio: lint-ignore[host-sync-in-hot-path]: the scrape reads the device counters; the serving path never does
        undispatched = float(self.undispatched.item())
        return [
            Metric(name="pio_moe_routed_pairs_total", kind="counter",
                   help="(position, expert) pairs dispatched by the MoE layers",
                   samples=[({"layer": str(i), "expert": str(e)}, float(n))
                            for i, row in enumerate(routed) for e, n in enumerate(row)]),
            Metric(name="pio_moe_undispatched_positions_total", kind="counter",
                   help="Padded positions the MoE layers left out",
                   samples=[({}, undispatched)]),
        ]

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Scores (..., V) in f32 of final hidden states ``h`` (..., d)
        against the untied head."""
        return (h.to(self.cfg.dtype) @ self.head).float()
