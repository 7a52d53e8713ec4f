"""The port's tied logits product (``models/seqrec.logits_from_hidden``)
runs in true f32 and leaves the process's TF32 setting as it found it.

The product of the f32 logits must not run in TF32 (10 mantissa bits),
in the forward pass or in the backward pass of training. It is scoped by
``utils/device.ieee_f32``: a user's own f32 products after a query or a
train step keep whatever ``torch.backends.cuda.matmul.allow_tf32`` they
set. On the CPU the flag changes no product, but it is the same process
state that the card reads, so holding it here holds it there.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.models import seqrec

CFG = seqrec.SeqRecConfig(vocab=40, max_len=16, d_model=32, n_heads=2, n_layers=1,
                          dtype=torch.float32)


@pytest.fixture
def tf32_flag():
    """Restores the process's flag after each case, whatever it did."""
    prev = torch.backends.cuda.matmul.allow_tf32
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _model() -> seqrec.SeqRec:
    torch.manual_seed(0)
    return seqrec.SeqRec(CFG, "cpu")


def _batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    seqs = torch.from_numpy(rng.integers(1, CFG.vocab, (3, CFG.max_len)))
    tgts = torch.from_numpy(rng.integers(1, CFG.vocab, (3, CFG.max_len)))
    seqs[2, 9:] = 0
    tgts[2, 8:] = 0
    return seqs, tgts


def _spy(monkeypatch) -> list[bool]:
    """Wraps seqrec's ``ieee_f32``: records the flag as each scope runs."""
    seen: list[bool] = []
    real = seqrec.ieee_f32

    @contextlib.contextmanager
    def spying():
        with real():
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            yield

    monkeypatch.setattr(seqrec, "ieee_f32", spying)
    return seen


@pytest.mark.parametrize("flag", [True, False])
def test_logits_from_hidden_keeps_the_flag(flag, tf32_flag, monkeypatch):
    torch.backends.cuda.matmul.allow_tf32 = flag
    seen = _spy(monkeypatch)
    model = _model()
    h = torch.randn(2, 5, CFG.d_model)
    out = seqrec.logits_from_hidden(model, h)
    assert torch.backends.cuda.matmul.allow_tf32 is flag
    assert seen == [False]                     # the product itself ran in f32
    torch.testing.assert_close(out, h @ model.item_emb.float().T, rtol=0, atol=0)


@pytest.mark.parametrize("flag", [True, False])
def test_predict_keeps_the_flag(flag, tf32_flag):
    torch.backends.cuda.matmul.allow_tf32 = flag
    seqs, _ = _batch()
    masks = torch.zeros(seqs.shape[0], CFG.vocab)
    seqrec.predict_topk_batch(_model(), seqs, 3, masks)
    assert torch.backends.cuda.matmul.allow_tf32 is flag


@pytest.mark.parametrize("flag", [True, False])
def test_train_step_keeps_the_flag_and_runs_both_passes_in_f32(flag, tf32_flag, monkeypatch):
    torch.backends.cuda.matmul.allow_tf32 = flag
    seen = _spy(monkeypatch)
    model = _model()
    step = seqrec.make_train_step(model)
    m, v = seqrec.adam_state(model)
    seqs, tgts = _batch()
    loss = step(m, v, 1, seqs, tgts, 1e-3)
    assert torch.isfinite(loss)
    assert torch.backends.cuda.matmul.allow_tf32 is flag
    # one scope for the forward product, one for the backward products
    assert seen == [False, False]


def test_backward_equals_the_plain_product():
    """The Function's gradients are the plain matmul's (float64 gradcheck
    and an f32 comparison with autograd's own)."""
    h = torch.randn(2, 3, 4, dtype=torch.float64, requires_grad=True)
    w = torch.randn(7, 4, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(seqrec._IeeeTiedLogits.apply, (h, w))
    h32 = torch.randn(2, 3, 4, requires_grad=True)
    w32 = torch.randn(7, 4, requires_grad=True)
    g = torch.randn(2, 3, 7)
    got = torch.autograd.grad(seqrec._IeeeTiedLogits.apply(h32, w32), (h32, w32), g)
    want = torch.autograd.grad(h32 @ w32.T, (h32, w32), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("flag", [True, False])
def test_overlapping_scopes_in_two_threads(flag, tf32_flag):
    """A opens, B opens, A closes, B closes (a served query beside the
    online fold thread): the flag stays off until the last scope closes,
    then is the caller's again."""
    from predictionio_tpu_torch.utils.device import ieee_f32

    torch.backends.cuda.matmul.allow_tf32 = flag
    a_open, b_open, a_closed = threading.Event(), threading.Event(), threading.Event()
    inside_b: list[bool] = []

    def a():
        with ieee_f32():
            a_open.set()
            b_open.wait(5)
        a_closed.set()

    def b():
        a_open.wait(5)
        with ieee_f32():
            b_open.set()
            a_closed.wait(5)
            inside_b.append(torch.backends.cuda.matmul.allow_tf32)

    threads = [threading.Thread(target=a), threading.Thread(target=b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert a_closed.is_set() and inside_b == [False]
    assert torch.backends.cuda.matmul.allow_tf32 is flag
