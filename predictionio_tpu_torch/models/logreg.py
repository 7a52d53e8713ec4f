"""Multinomial logistic regression on the device — the classification
template's second learner (port of the JAX package's ``models/logreg.py``).

Training is full-batch Adam on the masked softmax cross-entropy plus L2
(the bias row exempt) from W = 0: the JAX package's one scanned XLA
program with ``optax.adam(lr)`` (β₁ 0.9, β₂ 0.999, ε 1e-8) becomes an
eager loop of torch steps with Adam written out. The gradient is the
closed form, two products a step (logits X·W and Xᵀ·residual):
``Xᵀ(mask·(softmax − onehot))/n_real + 2·l2·W``, the bias row's L2 term
zeroed. With a ``mesh`` (``parallel/mesh.py``) the rows are padded to
the "data" axis multiple (padding rows carry a zero mask) and split over
it: each step every position computes its rows' loss and gradient
partials, normalized by the GLOBAL real-row count, ``psum`` adds them,
and the Adam update runs once, on the mesh's first device, whose weights
go back to every position. The fit equals the unsharded one up to the
order of the sums.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from predictionio_tpu_torch.parallel.mesh import (
    Mesh,
    device_put,
    local_map,
    psum,
    replicated,
    shard_batch,
)
from predictionio_tpu_torch.utils.device import as_device_tensor, ieee_f32, resolve_device

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class LogRegModel:
    """weights (F+1, C); the final row is the bias."""

    weights: torch.Tensor


def _add_bias(features: torch.Tensor) -> torch.Tensor:
    ones = torch.ones((features.shape[0], 1), dtype=features.dtype, device=features.device)
    return torch.cat([features, ones], dim=1)


def _data_loss_and_grad(X: torch.Tensor, one_hot: torch.Tensor, mask: torch.Tensor,
                        n_real: torch.Tensor,
                        W: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The rows' part of the loss, Σ masked cross-entropy / n_real, and
    of its gradient in W (``n_real`` counts the real rows of the whole
    batch, so the parts of row blocks add up to the whole's)."""
    logp = torch.log_softmax(X @ W, dim=1)                       # (N, C)
    ce = -(one_hot * logp).sum(1) * mask
    residual = (torch.exp(logp) - one_hot) * (mask / n_real)[:, None]
    return ce.sum() / n_real, X.T @ residual


def _with_l2(loss: torch.Tensor, grad: torch.Tensor, W: torch.Tensor,
             l2: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The L2 term added to the data part: l2·‖W[:-1]‖², the bias exempt."""
    reg_w = W.clone()
    reg_w[-1] = 0.0
    return loss + l2 * (reg_w * reg_w).sum(), grad + (2.0 * l2) * reg_w


def _loss_and_grad(X: torch.Tensor, one_hot: torch.Tensor, mask: torch.Tensor,
                   n_real: torch.Tensor, W: torch.Tensor,
                   l2: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The loss (masked mean cross-entropy + l2·‖W[:-1]‖²) and its
    gradient in W, in closed form."""
    return _with_l2(*_data_loss_and_grad(X, one_hot, mask, n_real, W), W, l2)


def _adam_step(W, m, v, g, t: int, lr: float):
    """One Adam update of W (m and v in place)."""
    m.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
    v.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
    # optax's bias corrections, 1 - β^t, are f32: so are these
    # (in f64, 1 - 0.999^t differs by ~1e-4 relative at t = 1)
    m_hat = m / float(1.0 - np.float32(ADAM_B1) ** np.float32(t))
    v_hat = v / float(1.0 - np.float32(ADAM_B2) ** np.float32(t))
    return W - lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)


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
            W = _adam_step(W, m, v, g, t, lr)
    return W


def _fit_mesh(mesh: Mesh, features: np.ndarray, labels: np.ndarray, num_classes: int,
              iterations: int, lr: float, l2: float) -> torch.Tensor:
    """:func:`_fit` over ``mesh`` (module docstring): W on the mesh's first
    device."""
    (f_s, lab_s, mask_s), _ = shard_batch(
        [features, np.asarray(labels, dtype=np.int64), np.ones(len(labels), np.float32)], mesh)
    X_s, oh_s = local_map(mesh, lambda f, lab: (
        _add_bias(f), torch.nn.functional.one_hot(lab, num_classes).to(f.dtype)), f_s, lab_s)
    home = mesh.positions[0]
    n_real = psum(local_map(mesh, lambda m: m.sum(), mask_s), "data").local(home).clamp_min(1.0)
    n_real_s = device_put(n_real, replicated(mesh))
    W = torch.zeros((X_s.shape[1], num_classes), dtype=torch.float32, device=n_real.device)
    m = torch.zeros_like(W)
    v = torch.zeros_like(W)
    with ieee_f32():
        for t in range(1, iterations + 1):
            parts = local_map(mesh, _data_loss_and_grad, X_s, oh_s, mask_s, n_real_s,
                              device_put(W, replicated(mesh)))
            loss, g = _with_l2(*(psum(p, "data").local(home) for p in parts), W, l2)
            W = _adam_step(W, m, v, g, t, lr)
    return W


def train_logreg(features, labels, num_classes: int, l2: float = 1e-4,
                 iterations: int = 300, lr: float = 0.1, mesh: Mesh | None = None,
                 device=None) -> LogRegModel:
    """Train softmax regression on ``device`` (a tensor's own device when
    None, else the card), or over ``mesh`` (module docstring)."""
    if mesh is not None:
        return LogRegModel(weights=_fit_mesh(mesh, np.asarray(features, dtype=np.float32),
                                             labels, num_classes, iterations, float(lr),
                                             float(l2)))
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
