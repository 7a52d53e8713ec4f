"""Naive Bayes on the device: multinomial (MLlib's) and categorical (the
e2 library's) — port of the JAX package's ``models/naive_bayes.py``.

All counting is one-hot contractions (``one_hot(labels).T @ features``),
plain torch on the context's device, in true f32 (``ieee_f32``): sums
of integer counts stay exact in f32 below 2^24. With a ``mesh``
(``parallel/mesh.py``) the rows are padded to the "data" axis multiple
(padding rows carry a zero mask) and split over it, each position counts
its rows, and ``psum`` adds the counts: integers, so the result is the
unsharded one exactly. The model lands on the mesh's first device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from predictionio_tpu_torch.parallel.mesh import Mesh, local_map, psum, shard_batch
from predictionio_tpu_torch.utils.device import as_device_tensor, ieee_f32, resolve_device


@dataclasses.dataclass
class MultinomialNBModel:
    """log priors (C,) and per-class log likelihoods theta (C, F)."""

    log_prior: torch.Tensor
    log_theta: torch.Tensor


def _multinomial_counts(features: torch.Tensor, labels: torch.Tensor,
                        sample_mask: torch.Tensor, num_classes: int):
    """Per-class feature sums (C, F) + class counts (C,) as one-hot
    contractions."""
    one_hot = torch.nn.functional.one_hot(labels.long(), num_classes).to(features.dtype)
    one_hot = one_hot * sample_mask[:, None]  # zero padded rows
    with ieee_f32():
        return one_hot.sum(0), one_hot.T @ features


def _multinomial_finalize(class_counts: torch.Tensor, feature_sums: torch.Tensor,
                          smoothing: float):
    num_features = feature_sums.shape[1]
    num_classes = class_counts.shape[0]
    # MLlib: smoothed priors log(n_c + λ) - log(N + C·λ), so a class
    # absent from a split gets a finite prior
    log_prior = (torch.log(class_counts + smoothing)
                 - torch.log(class_counts.sum() + smoothing * num_classes))
    log_theta = (torch.log(feature_sums + smoothing)
                 - torch.log(feature_sums.sum(1, keepdim=True) + smoothing * num_features))
    return log_prior, log_theta


def _sharded_counts(mesh: Mesh, count, features: np.ndarray, labels: np.ndarray):
    """``count(features, labels, mask)`` over ``mesh``: the rows padded
    and split over "data" (a zero mask on padding rows), each position's
    counts, and their ``psum``; the sums on the mesh's first device."""
    arrays, _ = shard_batch([features, np.asarray(labels, dtype=np.int64),
                             np.ones(len(labels), dtype=np.float32)], mesh)
    home = mesh.positions[0]
    return tuple(psum(c, "data").local(home) for c in local_map(mesh, count, *arrays))


def train_multinomial(features, labels, num_classes: int, smoothing: float = 1.0,
                      mesh: Mesh | None = None, device=None) -> MultinomialNBModel:
    """Multinomial NB with Laplace smoothing (MLlib ``NaiveBayes``):
    additive smoothing on term counts, class log priors from the
    frequencies; counted over ``mesh`` when given (module docstring)."""
    if mesh is not None:
        counts, sums = _sharded_counts(
            mesh, lambda f, lab, m: _multinomial_counts(f, lab, m, num_classes),
            np.asarray(features, dtype=np.float32), labels)
        return MultinomialNBModel(*_multinomial_finalize(counts, sums, float(smoothing)))
    f = as_device_tensor(features, torch.float32, device)
    lab = as_device_tensor(labels, torch.int64, f.device)
    counts, sums = _multinomial_counts(f, lab, torch.ones(lab.shape, device=f.device),
                                       num_classes)
    return MultinomialNBModel(*_multinomial_finalize(counts, sums, float(smoothing)))


def predict_multinomial_scores(log_prior: torch.Tensor, log_theta: torch.Tensor,
                               features: torch.Tensor) -> torch.Tensor:
    """Joint log likelihood per class: prior + X @ thetaᵀ (one product)."""
    with ieee_f32():
        return log_prior[None, :] + features @ log_theta.T


def predict_multinomial(model: MultinomialNBModel, features) -> np.ndarray:
    X = as_device_tensor(features, torch.float32, model.log_prior.device)
    return predict_multinomial_scores(model.log_prior, model.log_theta, X).argmax(1).cpu().numpy()


# ---------------------------------------------------------------------------
# Categorical NB (the e2 library's CategoricalNaiveBayes)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CategoricalNBModel:
    """log priors (C,); per-feature log likelihood tables (F, C, V),
    padded to the largest vocabulary; the score of an unseen value per
    (feature, class), log(1/denominator)."""

    log_prior: torch.Tensor        # (C,)
    log_likelihood: torch.Tensor   # (F, C, V)
    default_log: torch.Tensor      # (F, C)


def _categorical_counts(features: torch.Tensor, labels: torch.Tensor,
                        sample_mask: torch.Tensor, num_classes: int, num_values: int):
    """counts[f, c, v] = #rows with label c and feature f == v (a value
    of -1, missing, counts nowhere), as a one-hot contraction over the
    rows."""
    label_oh = torch.nn.functional.one_hot(labels.long(), num_classes).float()
    label_oh = label_oh * sample_mask[:, None]
    values = torch.arange(num_values, device=features.device)
    feat_oh = (features[:, :, None] == values).float()             # (N, F, V)
    with ieee_f32():
        counts = torch.einsum("nc,nfv->fcv", label_oh, feat_oh)
    return label_oh.sum(0), counts


def train_categorical(features, labels, num_classes: int, num_values: int,
                      smoothing: float = 1.0, mesh: Mesh | None = None,
                      device=None) -> CategoricalNBModel:
    """``features``: int category indices (N, F), -1 = missing; counted
    over ``mesh`` when given (module docstring)."""
    if mesh is not None:
        class_counts, counts = _sharded_counts(
            mesh, lambda f, lab, m: _categorical_counts(f, lab, m, num_classes, num_values),
            np.asarray(features, dtype=np.int32), labels)
    else:
        f = as_device_tensor(features, torch.int32, device)
        lab = as_device_tensor(labels, torch.int64, f.device)
        class_counts, counts = _categorical_counts(
            f, lab, torch.ones(lab.shape, device=f.device), num_classes, num_values)
    denom = class_counts[None, :, None] + smoothing * num_values
    return CategoricalNBModel(
        log_prior=torch.log(class_counts) - torch.log(class_counts.sum()),
        log_likelihood=torch.log(counts + smoothing) - torch.log(denom),
        default_log=-torch.log(denom[:, :, 0]))


def predict_categorical_scores(log_prior: torch.Tensor, log_likelihood: torch.Tensor,
                               default_log: torch.Tensor,
                               features: torch.Tensor) -> torch.Tensor:
    """scores[n, c] = prior[c] + Σ_f loglik[f, c, x_nf]; x = -1 takes the
    default score."""
    F, C, _ = log_likelihood.shape
    dev = features.device
    safe = features.clamp_min(0).long()                                  # (N, F)
    gathered = log_likelihood[torch.arange(F, device=dev)[None, :, None],
                              torch.arange(C, device=dev)[None, None, :],
                              safe[:, :, None]]                          # (N, F, C)
    scored = torch.where((features < 0)[:, :, None], default_log[None], gathered)
    return log_prior[None, :] + scored.sum(1)


def predict_categorical(model: CategoricalNBModel, features) -> np.ndarray:
    X = as_device_tensor(features, torch.int32, model.log_prior.device)
    return predict_categorical_scores(model.log_prior, model.log_likelihood,
                                      model.default_log, X).argmax(1).cpu().numpy()


def params_from_jax(log_prior: np.ndarray, log_theta: np.ndarray,
                    device=None) -> MultinomialNBModel:
    """A JAX-trained multinomial model from its arrays (``np.asarray`` of
    the JAX model's fields)."""
    dev = resolve_device(device)
    return MultinomialNBModel(
        *(torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
          for a in (log_prior, log_theta)))


def categorical_params_from_jax(log_prior: np.ndarray, log_likelihood: np.ndarray,
                                default_log: np.ndarray, device=None) -> CategoricalNBModel:
    """A JAX-trained categorical model from its arrays."""
    dev = resolve_device(device)
    return CategoricalNBModel(
        *(torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
          for a in (log_prior, log_likelihood, default_log)))
