"""Multinomial logistic regression on the device — the classification
template's second learner (port of the JAX package's ``models/logreg.py``).

Training is full-batch Adam on the masked softmax cross-entropy plus L2
(the bias row exempt) from W = 0: the JAX package's one scanned XLA
program with ``optax.adam(lr)`` (β₁ 0.9, β₂ 0.999, ε 1e-8) becomes an
eager loop of torch steps with Adam written out. The gradient is the
closed form, two products a step (logits X·W and Xᵀ·residual):
``Xᵀ(mask·(softmax − onehot))/n_real + 2·l2·W``, the bias row's L2 term
zeroed. A ``mesh`` raises: several cards are ROADMAP.md queue 1 item 15.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from predictionio_tpu_torch.models.naive_bayes import _MESH_ITEM
from predictionio_tpu_torch.utils.device import as_device_tensor, ieee_f32, resolve_device

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class LogRegModel:
    """weights (F+1, C); the final row is the bias."""

    weights: torch.Tensor


def _add_bias(features: torch.Tensor) -> torch.Tensor:
    ones = torch.ones((features.shape[0], 1), dtype=features.dtype, device=features.device)
    return torch.cat([features, ones], dim=1)


def _loss_and_grad(X: torch.Tensor, one_hot: torch.Tensor, mask: torch.Tensor,
                   n_real: torch.Tensor, W: torch.Tensor,
                   l2: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The loss (masked mean cross-entropy + l2·‖W[:-1]‖²) and its
    gradient in W, in closed form."""
    logp = torch.log_softmax(X @ W, dim=1)                       # (N, C)
    ce = -(one_hot * logp).sum(1) * mask
    reg_w = W.clone()
    reg_w[-1] = 0.0                                              # bias exempt
    loss = ce.sum() / n_real + l2 * (reg_w * reg_w).sum()
    residual = (torch.exp(logp) - one_hot) * (mask / n_real)[:, None]
    return loss, X.T @ residual + (2.0 * l2) * reg_w


def _fit(features: torch.Tensor, labels: torch.Tensor, sample_mask: torch.Tensor,
         num_classes: int, iterations: int, lr: float, l2: float,
         losses: list | None = None) -> torch.Tensor:
    """Full-batch Adam from W = 0; ``losses`` (a list) collects each
    step's loss as a device scalar, read by nobody here."""
    X = _add_bias(features)                                      # (N, F+1)
    n_real = sample_mask.sum().clamp_min(1.0)
    one_hot = torch.nn.functional.one_hot(labels.long(), num_classes).to(X.dtype)
    W = torch.zeros((X.shape[1], num_classes), dtype=X.dtype, device=X.device)
    m = torch.zeros_like(W)
    v = torch.zeros_like(W)
    with ieee_f32():
        for t in range(1, iterations + 1):
            loss, g = _loss_and_grad(X, one_hot, sample_mask, n_real, W, l2)
            if losses is not None:
                losses.append(loss)
            m.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
            v.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
            # optax's bias corrections, 1 - β^t, are f32: so are these
            # (in f64, 1 - 0.999^t differs by ~1e-4 relative at t = 1)
            m_hat = m / float(1.0 - np.float32(ADAM_B1) ** np.float32(t))
            v_hat = v / float(1.0 - np.float32(ADAM_B2) ** np.float32(t))
            W = W - lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
    return W


def train_logreg(features, labels, num_classes: int, l2: float = 1e-4,
                 iterations: int = 300, lr: float = 0.1, mesh=None,
                 device=None) -> LogRegModel:
    """Train softmax regression on ``device`` (a tensor's own device when
    None, else the card)."""
    if mesh is not None:
        raise NotImplementedError(_MESH_ITEM)
    f = as_device_tensor(features, torch.float32, device)
    lab = as_device_tensor(labels, torch.int64, f.device)
    return LogRegModel(weights=_fit(f, lab, torch.ones(lab.shape, device=f.device),
                                    num_classes, iterations, float(lr), float(l2)))


def predict_logreg_scores(weights: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
    """Per-class log probabilities: log_softmax(X·W) (one product)."""
    with ieee_f32():
        return torch.log_softmax(_add_bias(features.to(weights.dtype)) @ weights, dim=1)


def predict_logreg(model: LogRegModel, features) -> np.ndarray:
    X = as_device_tensor(features, torch.float32, model.weights.device)
    return predict_logreg_scores(model.weights, X).argmax(1).cpu().numpy()


def params_from_jax(weights: np.ndarray, device=None) -> LogRegModel:
    """A JAX-trained model from its (F+1, C) weights."""
    return LogRegModel(torch.from_numpy(np.array(weights, dtype=np.float32)).to(
        resolve_device(device)))
