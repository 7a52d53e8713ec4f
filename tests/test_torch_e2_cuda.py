"""The e2 device programs (``predictionio_tpu_torch/e2/engine.py``) on the
card against the same calls on the CPU: the naive Bayes count tables
exactly, and the Markov chain's dense build with its top-N ids exactly
(ties lowest index first) and its probabilities within ``PROB_TOL``.

Needs an NVIDIA card; every test skips without one. Imports no JAX, so
it runs on a machine without it:

    python -m pytest tests/test_torch_e2_cuda.py --noconftest
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.e2 import engine as e2

pytestmark = pytest.mark.cuda

#: f32 row sums of fractional counts, added in another order on the card
PROB_TOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n, f, labels, vocab", [(1000, 4, 3, 7), (200_000, 54, 7, 2)])
def test_nb_count_on_the_card_equals_the_cpu(cuda, n, f, labels, vocab):
    rng = np.random.default_rng(0)
    label_ix = rng.integers(0, labels, n).astype(np.int32)
    feat_ix = rng.integers(0, vocab, (n, f)).astype(np.int32)
    got = e2._nb_count(label_ix, feat_ix, labels, f, vocab, device=cuda)
    want = e2._nb_count(label_ix, feat_ix, labels, f, vocab, device="cpu")
    assert got[0].device.type == "cuda"
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n_states, n, fractional", [
    (300, 20_000, False), (2_000, 200_000, False), (2_000, 200_000, True)])
def test_markov_build_on_the_card_equals_the_cpu(cuda, n_states, n, fractional):
    rng = np.random.default_rng(1)
    rows = rng.integers(0, n_states, n)
    cols = (rows * 7 + rng.integers(0, 16, n) * 3) % n_states  # repeated counts: ties
    vals = rng.random(n).astype(np.float32) if fractional else np.ones(n, np.float32)
    args = [torch.from_numpy(a) for a in (rows, cols, vals)]
    gi, gp = e2.markov_top_transitions(n_states, *(a.to(cuda) for a in args), 10)
    wi, wp = e2.markov_top_transitions(n_states, *args, 10)
    if not fractional:
        assert torch.equal(gi.cpu(), wi)
    else:
        # fractional counts may reorder near-equal probabilities; the
        # values must still agree slot by slot
        assert (gi.cpu() == wi).float().mean() > 0.99
    torch.testing.assert_close(gp.cpu(), wp, atol=PROB_TOL, rtol=0)


def test_markov_chain_trains_on_the_card_by_default(cuda):
    tr = [(0, 4, 1.0), (0, 2, 1.0), (0, 7, 1.0), (0, 1, 1.0), (3, 5, 2.0)]
    model = e2.MarkovChain.train(8, tr, top_n=3)
    assert model.predict(0) == [(1, 0.25), (2, 0.25), (4, 0.25)]
    assert model.transition_index.dtype == np.int32
