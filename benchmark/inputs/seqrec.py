"""The sessionrec cells' inputs, made from the run's seed: the model's
weights (on the device, in a few large draws of one generator) and the
users' histories (on the host, in bulk). The driver hands them to the
program and the check hands the same to the reference, each making them
anew from the seed.

Weights are float32, the type the program serves them in (it casts to
the configuration's dtype at each product). Matrices are normal with
variance 1/fan-in; LayerNorm gains are 1 + 0.1·N(0,1) and its shifts and
the MLP biases small normals, so every term of the model carries
weight. The key names are the program's state-dict names.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

from benchmark.harness import traffic as tr


def weight_shapes(cfg: Mapping) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, kind) of every weight: kind "matrix" (fan-in the
    first dim), "gain", "shift" or "embedding"."""
    d, V, S = cfg["d_model"], cfg["vocab"], cfg["max_len"]
    h = cfg["mlp_mult"] * d
    out = [("item_emb", (V, d), "embedding"), ("pos_emb", (S, d), "embedding"),
           ("out_ln.g", (d,), "gain"), ("out_ln.b", (d,), "shift")]
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        out += [(p + "ln1.g", (d,), "gain"), (p + "ln1.b", (d,), "shift"),
                (p + "ln2.g", (d,), "gain"), (p + "ln2.b", (d,), "shift"),
                (p + "wqkv", (d, 3 * d), "matrix"), (p + "wo", (d, d), "matrix"),
                (p + "w1", (d, h), "matrix"), (p + "b1", (h,), "shift"),
                (p + "w2", (h, d), "matrix"), (p + "b2", (d,), "shift")]
    return out


def make_weights(cfg: Mapping, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """Every weight from one draw of normals on ``device``, then scaled
    per tensor: views of one buffer, so each is contiguous."""
    shapes = weight_shapes(cfg)
    total = sum(math.prod(s) for _, s, _ in shapes)
    gen = torch.Generator(device=device).manual_seed(tr.torch_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, pos = {}, 0
    d = cfg["d_model"]
    for name, shape, kind in shapes:
        n = math.prod(shape)
        t = flat[pos:pos + n].view(shape)
        pos += n
        if kind == "embedding":
            t.mul_(1.0 / math.sqrt(d))
        elif kind == "matrix":
            t.mul_(1.0 / math.sqrt(shape[0]))
        elif kind == "gain":
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(0.02)
        out[name] = t
    return out


def make_histories(traffic: Mapping, cfg: Mapping, seed: int) -> list[np.ndarray]:
    """One item-id history per user (``traffic["users"]`` of them)."""
    return tr.sequences(traffic["history"], int(traffic["users"]), cfg,
                        tr.rng(seed, "data"))


def user_name(index: int) -> str:
    return f"u{index}"
