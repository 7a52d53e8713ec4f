"""The port's e2 library (``predictionio_tpu_torch/e2/{engine,evaluation}.py``)
against the JAX package's on the CPU, on inputs made from a numpy seed:
the naive Bayes count tables and log tables exactly (integer counts, so
exact in any summation order), predictions and scores; the Markov
chain's top-N ids exactly — ties lowest index first, as ``lax.top_k``
orders them — and its probabilities within ``PROB_TOL``; the binary
vectorizer; and ``cross_validation_split``. Mirrors tests/test_e2.py.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

from predictionio_tpu.e2 import engine as je
from predictionio_tpu.e2 import evaluation as jev
from predictionio_tpu_torch.e2 import (
    BinaryVectorizer,
    CategoricalNaiveBayes,
    LabeledPoint,
    MarkovChain,
    cross_validation_split,
)
from predictionio_tpu_torch.e2 import engine as pe

#: transition probabilities: f32 count / f32 row sum, the row sums added
#: in another order than XLA's when the counts are fractional
PROB_TOL = 1e-6


def _points(seed: int, n: int, n_features: int, n_labels: int, vocab: int):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_labels, n)
    # the features lean on the label, so the likelihoods differ by label
    feats = (rng.integers(0, vocab, (n, n_features)) + labels[:, None]) % vocab
    return [(f"l{lab}", tuple(f"v{pos}_{x}" for pos, x in enumerate(row)))
            for lab, row in zip(labels, feats)]


class TestCategoricalNaiveBayes:
    @pytest.mark.parametrize("seed, n, f, labels, vocab", [
        (0, 5, 2, 2, 3), (1, 200, 4, 3, 5), (2, 1000, 7, 5, 11), (3, 50, 1, 1, 2)])
    def test_tables_equal_jax(self, seed, n, f, labels, vocab):
        pts = _points(seed, n, f, labels, vocab)
        got = CategoricalNaiveBayes.train([LabeledPoint(*p) for p in pts], device="cpu")
        want = je.CategoricalNaiveBayes.train([je.LabeledPoint(*p) for p in pts])
        assert got.labels.to_dict() == want.labels.to_dict()
        assert [m.to_dict() for m in got.value_maps] == [m.to_dict() for m in want.value_maps]
        np.testing.assert_array_equal(got.log_priors, want.log_priors)
        np.testing.assert_array_equal(got.log_likelihoods, want.log_likelihoods)
        assert got.log_likelihoods.dtype == want.log_likelihoods.dtype

    def test_counts_equal_bincount(self):
        rng = np.random.default_rng(4)
        label_ix = rng.integers(0, 3, 500).astype(np.int32)
        feat_ix = rng.integers(0, 6, (500, 4)).astype(np.int32)
        lc, vc = pe._nb_count(label_ix, feat_ix, 3, 4, 6, device="cpu")
        jlc, jvc = je._nb_count(label_ix, feat_ix, 3, 4, 6)
        np.testing.assert_array_equal(lc.numpy(), np.bincount(label_ix, minlength=3))
        np.testing.assert_array_equal(lc.numpy(), np.asarray(jlc))
        np.testing.assert_array_equal(vc.numpy(), np.asarray(jvc))
        for pos in range(4):
            for lab in range(3):
                np.testing.assert_array_equal(
                    vc.numpy()[lab, pos], np.bincount(feat_ix[label_ix == lab, pos], minlength=6))

    @pytest.mark.parametrize("seed", [1, 2])
    def test_scores_and_predictions_equal_jax(self, seed):
        pts = _points(seed, 300, 3, 4, 6)
        got = CategoricalNaiveBayes.train([LabeledPoint(*p) for p in pts], device="cpu")
        want = je.CategoricalNaiveBayes.train([je.LabeledPoint(*p) for p in pts])
        probes = pts[:20] + [("l0", ("v0_1", "UNSEEN", "v2_3")), ("nolabel", pts[0][1])]
        avg = lambda ls: sum(ls) / len(ls) if ls else -math.inf  # noqa: E731
        for label, feats in probes:
            assert got.log_score(LabeledPoint(label, feats)) == \
                want.log_score(je.LabeledPoint(label, feats))
            assert got.log_score(LabeledPoint(label, feats), avg) == \
                want.log_score(je.LabeledPoint(label, feats), avg)
            assert got.predict(feats) == want.predict(feats)

    def test_empty_raises(self):
        with pytest.raises(ValueError, match="zero points"):
            CategoricalNaiveBayes.train([], device="cpu")


def _transitions(seed: int, n_states: int, n: int, fractional: bool):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_states, n)
    # few distinct targets per row: counts repeat, so probabilities tie
    cols = (rows * 7 + rng.integers(0, 4, n) * 3) % n_states
    vals = rng.random(n).astype(np.float32) if fractional else np.ones(n, np.float32)
    return [(int(r), int(c), float(v)) for r, c, v in zip(rows, cols, vals)]


class TestMarkovChain:
    @pytest.mark.parametrize("seed, n_states, n, top_n, fractional", [
        (0, 5, 40, 2, False), (1, 60, 2000, 10, False), (2, 200, 3000, 10, False),
        (3, 60, 2000, 3, True), (4, 8, 10, 20, False), (5, 300, 100, 10, True)])
    def test_ids_exact_and_probs_equal_jax(self, seed, n_states, n, top_n, fractional):
        tr = _transitions(seed, n_states, n, fractional)
        got = MarkovChain.train(n_states, tr, top_n=top_n, device="cpu")
        want = je.MarkovChain.train(n_states, tr, top_n=top_n)
        assert (got.n_states, got.top_n) == (want.n_states, want.top_n)
        assert got.transition_index.dtype == want.transition_index.dtype
        np.testing.assert_array_equal(got.transition_index, want.transition_index)
        np.testing.assert_allclose(got.transition_prob, want.transition_prob,
                                   rtol=0, atol=PROB_TOL)
        for s in range(min(n_states, 10)):
            assert [j for j, _ in got.predict(s)] == [j for j, _ in want.predict(s)]

    def test_ties_lowest_index_first(self):
        """Row 0 moves to 4, 2, 7 and 1 once each: four equal
        probabilities, of which top 3 keeps 1, 2, 4 in that order."""
        tr = [(0, 4, 1.0), (0, 2, 1.0), (0, 7, 1.0), (0, 1, 1.0), (3, 5, 2.0)]
        got = MarkovChain.train(8, tr, top_n=3, device="cpu")
        want = je.MarkovChain.train(8, tr, top_n=3)
        assert got.predict(0) == [(1, 0.25), (2, 0.25), (4, 0.25)] == want.predict(0)
        assert got.transition_index[1].tolist() == [-1, -1, -1]  # a row with no transition
        assert got.predict(3) == [(5, 1.0)]

    def test_dense_build_on_tensors(self):
        import torch

        tr = _transitions(7, 40, 500, False)
        rows, cols, vals = (torch.tensor([t[i] for t in tr]) for i in range(3))
        idx, prob = pe.markov_top_transitions(40, rows, cols, vals.float(), 5)
        want = je.MarkovChain.train(40, tr, top_n=5)
        np.testing.assert_array_equal(idx.numpy(), want.transition_index)
        np.testing.assert_allclose(prob.numpy(), want.transition_prob, atol=PROB_TOL)


class TestBinaryVectorizer:
    def test_fit_and_encode_equal_jax(self):
        rng = np.random.default_rng(0)
        pairs = [(f"p{a}", f"v{b}") for a, b in rng.integers(0, 4, (40, 2))]
        got, want = BinaryVectorizer.fit(pairs), je.BinaryVectorizer.fit(pairs)
        assert len(got) == len(want)
        assert got.property_map.to_dict() == want.property_map.to_dict()
        batch = [pairs[i:i + 5] + [("unknown", "x")] for i in range(0, 40, 5)]
        np.testing.assert_array_equal(got.to_binary(batch[0]), want.to_binary(batch[0]))
        np.testing.assert_array_equal(got.to_binary_batch(batch), want.to_binary_batch(batch))


class TestCrossValidation:
    @pytest.mark.parametrize("n, k", [(10, 3), (7, 7), (20, 1), (3, 5)])
    def test_split_equals_jax(self, n, k):
        data = [(f"u{i}", i * 2) for i in range(n)]
        args = (lambda ds: tuple(ds), lambda d: (d[0], d[1]), {"k": k})
        got = cross_validation_split(data, k, *args)
        want = jev.cross_validation_split(data, k, *args)
        assert got == want
        held = sorted(q for _, _, qa in got for q, _ in qa)
        assert held == sorted(d[0] for d in data)

    def test_k_must_be_positive(self):
        for split in (cross_validation_split, jev.cross_validation_split):
            with pytest.raises(ValueError, match="positive"):
                split([1, 2], 0, list, lambda d: (d, d))
