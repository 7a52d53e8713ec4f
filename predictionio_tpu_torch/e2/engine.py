"""e2 engine primitives: CategoricalNaiveBayes, MarkovChain,
BinaryVectorizer (port of the JAX package's ``e2/engine.py``).

The reference computed counts with RDD aggregations. Here the host
encodes strings to dense indices (BiMap) and the counting, normalizing
and top-N math runs on the device as plain torch: ``bincount`` onto
count tables (the JAX package's ``segment_sum``), and a dense transition
build whose top-N goes through ``ops/topk.topk_lowest_index``, which
orders ties as ``lax.top_k`` does (lower index first). Both run on the
card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.ops.topk import topk_lowest_index
from predictionio_tpu_torch.utils.bimap import BiMap
from predictionio_tpu_torch.utils.device import resolve_device

# ---------------------------------------------------------------------------
# CategoricalNaiveBayes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LabeledPoint:
    """A string label + string-categorical feature vector (the
    reference's LabeledPoint)."""

    label: str
    features: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class CategoricalNaiveBayesModel:
    """Log priors + per-(feature-position, value) log likelihoods (the
    reference's CategoricalNaiveBayesModel).

    Arrays: ``log_priors`` [L]; ``log_likelihoods`` [L, F, V] where V is
    the per-position vocab padded to the max; lookups go through the label
    and per-position value BiMaps.
    """

    labels: BiMap
    value_maps: tuple[BiMap, ...]      # one per feature position
    log_priors: np.ndarray             # [L]
    log_likelihoods: np.ndarray        # [L, F, V]

    def log_score(
        self,
        point: LabeledPoint,
        default_likelihood: Callable[[Sequence[float]], float] = lambda ls: -math.inf,
    ) -> float | None:
        """Log P(label, features) for the point's own label; None for an
        unseen label. ``default_likelihood`` maps the label's OTHER
        likelihoods at that position to a score for an unseen value."""
        label_ix = self.labels.get(point.label)
        if label_ix is None:
            return None
        return self._score(label_ix, point.features, default_likelihood)

    def _score(self, label_ix, features, default_likelihood):
        total = float(self.log_priors[label_ix])
        for pos, value in enumerate(features):
            value_ix = self.value_maps[pos].get(value)
            row = self.log_likelihoods[label_ix, pos]
            if value_ix is None:
                # the reference's likelihood Map holds only values SEEN
                # with this label; pass those (finite entries), not the
                # padded vocab row
                vocab = len(self.value_maps[pos])
                seen = [float(v) for v in row[:vocab] if math.isfinite(v)]
                total += default_likelihood(seen)
            else:
                total += float(row[value_ix])
        return total

    def predict(self, features: Sequence[str]) -> str:
        """Argmax label; unseen values contribute -inf like the
        reference's default. When every label ties at -inf, the first
        label wins (argmax-of-ties), so a label string is always
        returned."""
        best_label, best = None, -math.inf
        for label, label_ix in self.labels.to_dict().items():
            s = self._score(label_ix, tuple(features), lambda ls: -math.inf)
            if best_label is None or s > best:
                best_label, best = label, s
        return best_label


class CategoricalNaiveBayes:
    """The reference's CategoricalNaiveBayes.train."""

    @staticmethod
    def train(points: Sequence[LabeledPoint],
              device: str | torch.device | None = None) -> CategoricalNaiveBayesModel:
        """Counts on ``device`` (default ``cuda``); the model's tables
        come back to the host."""
        if not points:
            raise ValueError("cannot train on zero points")
        n_features = len(points[0].features)
        labels = BiMap.string_int(p.label for p in points)
        value_maps = tuple(
            BiMap.string_int(p.features[pos] for p in points)
            for pos in range(n_features)
        )
        n_labels = len(labels)
        max_vocab = max((len(m) for m in value_maps), default=1)

        # encode to dense indices on host; count on the device
        label_ix = np.asarray([labels[p.label] for p in points], dtype=np.int32)
        feat_ix = np.asarray(
            [[value_maps[pos][p.features[pos]] for pos in range(n_features)]
             for p in points],
            dtype=np.int32,
        ).reshape(len(points), n_features)

        label_counts, value_counts = _nb_count(
            label_ix, feat_ix, n_labels, n_features, max_vocab, device=device
        )
        # f32 end-to-end: counts are integers well under 2**24, so the
        # log-space priors/likelihoods lose nothing vs an f64 copy
        label_counts = label_counts.cpu().numpy()
        value_counts = value_counts.cpu().numpy()

        log_priors = np.log(label_counts) - math.log(len(points))
        with np.errstate(divide="ignore"):
            log_likelihoods = np.log(value_counts) - np.log(
                label_counts[:, None, None]
            )
        # mask out-of-vocab padding per position
        for pos, m in enumerate(value_maps):
            log_likelihoods[:, pos, len(m):] = -np.inf
        return CategoricalNaiveBayesModel(
            labels=labels,
            value_maps=value_maps,
            log_priors=log_priors,
            log_likelihoods=log_likelihoods,
        )


def _nb_count(label_ix, feat_ix, n_labels, n_features, max_vocab,
              device: str | torch.device | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The count tables, f32 on ``device``: per label, and per (label,
    feature position, value) cell, each as one ``bincount`` of flat cell
    ids (the JAX package's two ``segment_sum``s). Integer counts, so
    exact in any summation order. The indices are NumPy arrays or
    tensors."""
    dev = resolve_device(device)
    label_ix = torch.as_tensor(label_ix, device=dev).long()
    feat_ix = torch.as_tensor(feat_ix, device=dev).long()
    label_counts = torch.bincount(label_ix, minlength=n_labels).float()
    # flatten (label, position, value) to one cell id
    pos_ix = torch.arange(n_features, dtype=torch.int64, device=dev)[None, :]
    flat = (label_ix[:, None] * (n_features * max_vocab) + pos_ix * max_vocab
            + feat_ix).reshape(-1)
    value_counts = torch.bincount(flat, minlength=n_labels * n_features * max_vocab)
    return label_counts, value_counts.float().reshape(n_labels, n_features, max_vocab)


# ---------------------------------------------------------------------------
# MarkovChain
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MarkovChainModel:
    """Top-N outgoing transitions per state (the reference's
    MarkovChainModel)."""

    n_states: int
    top_n: int
    #: [S, top_n] column indices and normalized probabilities, -1 padded
    transition_index: np.ndarray
    transition_prob: np.ndarray

    def predict(self, state: int) -> list[tuple[int, float]]:
        """Top transitions from ``state``."""
        out = []
        for j, p in zip(self.transition_index[state], self.transition_prob[state]):
            if j >= 0 and p > 0:
                out.append((int(j), float(p)))
        return out


def markov_top_transitions(n_states: int, rows: torch.Tensor, cols: torch.Tensor,
                           vals: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense build on the tensors' device: scatter-add the
    transitions into an [S, S] f32 table, normalize each row by its sum
    (a row whose sum is not positive gives zeros), keep each row's top
    ``k`` with ties lowest index first, and index -1 where p = 0.
    Returns (indices int64, probabilities f32), each [S, k]."""
    dense = torch.zeros((n_states, n_states), dtype=torch.float32, device=vals.device)
    dense.index_put_((rows.long(), cols.long()), vals.float(), accumulate=True)
    row_sums = dense.sum(dim=1, keepdim=True)
    dense.div_(row_sums.clamp_min(1e-30)).masked_fill_(~(row_sums > 0), 0.0)
    top_p, top_i = topk_lowest_index(dense, k)
    return torch.where(top_p > 0, top_i, -1), top_p


class MarkovChain:
    """The reference's MarkovChain.train: row-normalize the
    transition-count matrix, keep the top-N per row (a dense [S, S]
    build on the device)."""

    @staticmethod
    def train(
        n_states: int,
        transitions: Sequence[tuple[int, int, float]],
        top_n: int = 10,
        device: str | torch.device | None = None,
    ) -> MarkovChainModel:
        dev = resolve_device(device)
        rows = np.asarray([t[0] for t in transitions], dtype=np.int32)
        cols = np.asarray([t[1] for t in transitions], dtype=np.int32)
        vals = np.asarray([t[2] for t in transitions], dtype=np.float32)
        k = min(top_n, n_states)
        top_i, top_p = markov_top_transitions(
            n_states, torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev),
            torch.from_numpy(vals).to(dev), k)
        return MarkovChainModel(
            n_states=n_states,
            top_n=k,
            transition_index=top_i.to(torch.int32).cpu().numpy(),
            transition_prob=top_p.cpu().numpy(),
        )


# ---------------------------------------------------------------------------
# BinaryVectorizer
# ---------------------------------------------------------------------------


class BinaryVectorizer:
    """(property, value) -> one-hot index encoder (the reference's
    BinaryVectorizer)."""

    def __init__(self, property_map: BiMap):
        self.property_map = property_map

    @staticmethod
    def fit(pairs) -> "BinaryVectorizer":
        """Build the index from observed (property, value) pairs."""
        return BinaryVectorizer(BiMap.string_int(tuple(p) for p in pairs))

    def __len__(self) -> int:
        return len(self.property_map)

    def to_binary(self, pairs: Sequence[tuple[str, str]]) -> np.ndarray:
        """One-hot encode; unknown pairs are ignored."""
        vec = np.zeros(len(self.property_map), dtype=np.float32)
        for pair in pairs:
            ix = self.property_map.get(tuple(pair))
            if ix is not None:
                vec[ix] = 1.0
        return vec

    def to_binary_batch(self, batch: Sequence[Sequence[tuple[str, str]]]) -> np.ndarray:
        """[B, D] one-hot matrix, the batched form algorithms feed to the
        device."""
        out = np.zeros((len(batch), len(self.property_map)), dtype=np.float32)
        for i, pairs in enumerate(batch):
            out[i] = self.to_binary(pairs)
        return out
