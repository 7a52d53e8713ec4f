"""The MoE sessionrec cell's inputs, made from the run's seed: the
model's weights (on the device, one draw per tensor of one generator)
and the users' histories (on the host, in bulk, as the sessionrec cells
make them). ``drivers/moe_seqrec_serve.py`` hands the weights to the
program and the check hands the same values to the reference, each
making them anew from the seed.

Weights are drawn in float32 and rounded to bfloat16 once: the program
holds them in bf16 (``models/moe_seqrec.py``), and the reference is
handed the same bf16 tensors and upcasts each to float32 where it uses
it (at 12B parameters a float32 copy of the whole model would not fit
the card beside the bf16 one).
Matrices (each expert's own) are normal with variance 1/fan-in, the
item table normal with variance 1/hidden; RMSNorm gains are 1 +
0.1·N(0,1), so every term of the model carries weight. The key names
are the program's state-dict names (``models/moe_seqrec.weight_shapes``,
copied here so that the inputs do not come from the code under test).
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

from benchmark.harness import traffic as tr
from benchmark.inputs.seqrec import make_histories as _histories
from benchmark.inputs.seqrec import user_name  # noqa: F401  (the drivers' user names)


def weight_shapes(cfg: Mapping) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of every weight, in the (in, out) layout."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    H, Hkv, D = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    E, f = cfg["num_experts"], cfg["moe_intermediate_size"]
    out = [("item_emb", (V, d)), ("final_norm", (d,)), ("head", (d, V))]
    for i in range(int(cfg["num_hidden_layers"])):
        p = f"layers.{i}."
        out += [(p + "attn_norm", (d,)), (p + "wqkv", (d, (H + 2 * Hkv) * D)),
                (p + "wo", (H * D, d)), (p + "moe_norm", (d,)), (p + "router", (d, E)),
                (p + "w_gate_up", (E, d, 2 * f)), (p + "w_down", (E, f, d))]
    return out


def make_weights(cfg: Mapping, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """Every weight in bf16 on ``device``: drawn in f32 one tensor at a
    time, scaled, rounded once."""
    gen = torch.Generator(device=device).manual_seed(tr.torch_seed(seed, "weights"))
    out = {}
    for name, shape in weight_shapes(cfg):
        t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        if name.endswith("norm"):
            t.mul_(0.1).add_(1.0)
        else:
            fan_in = cfg["hidden_size"] if name == "item_emb" else shape[-2]
            t.mul_(1.0 / math.sqrt(fan_in))
        out[name] = t.to(torch.bfloat16)
        del t
    return out


def make_histories(traffic: Mapping, cfg: Mapping, seed: int) -> list[np.ndarray]:
    """One item-id history per user (``traffic["users"]`` of them)."""
    return _histories(traffic, cfg, seed)
