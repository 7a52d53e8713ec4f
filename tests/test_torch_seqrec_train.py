"""The port's SeqRec training (``models/seqrec.py``) held against the JAX
package's on the CPU: loss and gradients, the Adam step, whole training
runs, checkpoint/resume and remat.

Weights are JAX's own draw (``init_params(PRNGKey)``), carried over
through ``params_from_jax``; sequences are made with numpy from a seed.
Tolerances, stated per case:

- f32 loss: relative 1e-5; f32 gradients: rtol 1e-5, atol 1e-6 (the
  same f32 arithmetic in another summation order; measured ~1e-7).
- bf16 loss: relative 1e-3; bf16 gradients: per tensor, relative
  Frobenius error 3e-2 (both frameworks round every cast of the forward
  and its gradient to bf16, 2**-9 relative each, but fuse the
  elementwise work differently, so single roundings land one step
  apart; measured ~1e-2).
- Adam: rtol 1e-6 and atol 1e-8, a few f32 steps of an update of size
  lr (JAX computes 1 - b**step in f32 under jit, as the port does; the
  rest is the same f32 arithmetic).
- parameters after Adam steps: Adam moves a parameter by
  lr·m/(sqrt(v)+eps), about lr whatever the size of its gradient, so a
  gradient near zero, whose few significant bits differ between the
  frameworks, moves by a different fraction of lr in each. f32: atol
  lr/100 (measured up to 2e-6 at lr 1e-3 after one step, ~1e-7 after a
  four-epoch run); bf16, where rounding can turn such a gradient's sign:
  atol 2·lr after one step, lr·steps after a run, with the median within
  lr/10.
"""

from __future__ import annotations

import dataclasses
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.models import seqrec as jseqrec
from predictionio_tpu_torch.models import seqrec
from predictionio_tpu_torch.ops.attention import blockwise_attention, full_attention

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _configs(dtype: str, **kw):
    jdt, tdt = DTYPES[dtype]
    fields = dict(vocab=120, max_len=32, d_model=32, n_heads=2, n_layers=2) | kw
    return jseqrec.SeqRecConfig(dtype=jdt, **fields), seqrec.SeqRecConfig(dtype=tdt, **fields)


def _batch(cfg, seed: int, batch: int = 4):
    """Right-padded inputs and targets; the last row is all PAD."""
    rng = np.random.default_rng(seed)
    seqs = rng.integers(1, cfg.vocab, (batch, cfg.max_len))
    tgts = rng.integers(1, cfg.vocab, (batch, cfg.max_len))
    for i, n in enumerate(np.linspace(cfg.max_len, 0, batch).astype(int)):
        seqs[i, n:] = 0
        tgts[i, max(n - 1, 0):] = 0
    return seqs, tgts


def _as_port(tree) -> dict[str, np.ndarray]:
    """A JAX parameter-shaped pytree (params, grads, moments) by port key."""
    return {k: v.numpy() for k, v in seqrec.params_from_jax(jax.tree.map(np.asarray, tree)).items()}


def _port_model(tcfg, jparams) -> seqrec.SeqRec:
    model = seqrec.SeqRec(tcfg, "cpu")
    model.load_state_dict(seqrec.params_from_jax(jax.tree.map(np.asarray, jparams)))
    return model.requires_grad_()


def _loss_and_grads(model, seqs, tgts, **kw):
    loss = seqrec.next_item_loss(model, torch.from_numpy(seqs), torch.from_numpy(tgts), **kw)
    loss.backward()
    return loss.item(), {k: p.grad.numpy() for k, p in model.named_parameters()}


def _assert_grads_close(got: dict, want: dict, dtype: str) -> None:
    assert set(got) == set(want)
    for k in want:
        if dtype == "f32":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            err = np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]), 1e-30)
            assert err <= 3e-2, (k, err)


LOSS_RTOL = {"f32": 1e-5, "bf16": 1e-3}


class TestNextItemLossVsJax:
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("route", ["flat", "tiled", "blockwise_s4096"])
    def test_value_and_gradients(self, dtype, route, monkeypatch):
        if route == "blockwise_s4096":
            # S >= 4096: the JAX forward and the port's route to blockwise
            # attention with 128-query tiles (tests/test_attention.py:143)
            jcfg, tcfg = _configs(dtype, vocab=50, max_len=4096, d_model=32, n_layers=1)
            seqs, tgts = _batch(tcfg, 3, batch=2)
        else:
            jcfg, tcfg = _configs(dtype)
            seqs, tgts = _batch(tcfg, 0)
        if route == "tiled":
            # force tile 8 of the 32 positions, as the JAX test does
            budget = 4 * tcfg.vocab * 8 * 4
            monkeypatch.setattr(jseqrec, "_LOSS_TILE_BYTES", budget)
            monkeypatch.setattr(seqrec, "_LOSS_TILE_BYTES", budget)
            assert seqrec._pick_loss_tile(4, 32, tcfg.vocab) == jseqrec._pick_loss_tile(
                4, 32, tcfg.vocab) == 8
        jparams = jseqrec.init_params(jax.random.PRNGKey(1), jcfg)
        want, jgrads = jax.value_and_grad(jseqrec.next_item_loss)(
            jparams, jnp.asarray(seqs, jnp.int32), jnp.asarray(tgts, jnp.int32), jcfg)
        got, grads = _loss_and_grads(_port_model(tcfg, jparams), seqs, tgts)
        assert np.isfinite(got)
        assert abs(got - float(want)) <= LOSS_RTOL[dtype] * abs(float(want))
        _assert_grads_close(grads, _as_port(jgrads), dtype)

    def test_training_routes(self):
        route = seqrec.train_attention(4096)
        assert route.func is blockwise_attention and route.keywords == {"q_block": 128}
        assert seqrec.train_attention(256) is full_attention
        assert seqrec.train_attention(4000) is full_attention   # 4000 % 128 != 0
        assert seqrec.train_attention(8192).keywords == {"q_block": 128}

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("attention", ["full", "blockwise"])
    def test_all_pad_rows_give_exactly_zero(self, dtype, attention):
        """The padding rows ``train`` adds: zero loss and exactly zero
        gradient on both attention routes (full attention gives their
        queries the uniform average of V, blockwise zero)."""
        jcfg, tcfg = _configs(dtype)
        model = _port_model(tcfg, jseqrec.init_params(jax.random.PRNGKey(2), jcfg))
        pad = np.zeros((3, tcfg.max_len), np.int64)
        fn = full_attention if attention == "full" else functools.partial(
            blockwise_attention, q_block=8)
        loss, grads = _loss_and_grads(model, pad, pad, attention=fn)
        assert loss == 0.0
        assert all(not g.any() for g in grads.values())

    def test_pick_loss_tile_matches_jax(self):
        for b, s, v in [(64, 256, 50_000), (4, 4096, 50_000), (64, 4096, 500_000),
                        (1, 7, 10**9), (8, 96, 3_000_000)]:
            assert seqrec._pick_loss_tile(b, s, v) == jseqrec._pick_loss_tile(b, s, v)


class TestAdamVsJax:
    def test_updates_match_over_steps(self):
        rng = np.random.default_rng(4)
        shapes = [(5, 3), (7,)]
        p = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        jp, jm, jv = p, [np.zeros(s, np.float32) for s in shapes], [np.zeros(s, np.float32)
                                                                   for s in shapes]
        tp = [torch.from_numpy(x.copy()) for x in p]
        tm = [torch.zeros(s) for s in shapes]
        tv = [torch.zeros(s) for s in shapes]
        for step in range(1, 30):
            g = [(rng.standard_normal(s) * 10.0 ** rng.integers(-6, 1)).astype(np.float32)
                 for s in shapes]
            jp, jm, jv = jax.jit(jseqrec._adam_update)(
                [jnp.asarray(x) for x in jp], [jnp.asarray(x) for x in g], jm, jv, step,
                jnp.float32(3e-3))
            seqrec._adam_update(tp, [torch.from_numpy(x) for x in g], tm, tv, step, 3e-3)
            for a, b in zip(tp + tm + tv, list(jp) + list(jm) + list(jv)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-8)

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_one_train_step_matches_jax(self, dtype):
        jcfg, tcfg = _configs(dtype)
        seqs, tgts = _batch(tcfg, 5)
        jparams = jseqrec.init_params(jax.random.PRNGKey(3), jcfg)
        zeros = jax.tree.map(jnp.zeros_like, jparams)
        jp, jm, jv, jloss = jseqrec.make_train_step(jcfg)(
            jparams, zeros, zeros, 1, jnp.asarray(seqs, jnp.int32),
            jnp.asarray(tgts, jnp.int32), jnp.float32(1e-3))
        model = _port_model(tcfg, jparams)
        opt_m, opt_v = seqrec.adam_state(model)
        loss = seqrec.make_train_step(model)(opt_m, opt_v, 1, torch.from_numpy(seqs),
                                             torch.from_numpy(tgts), 1e-3)
        assert abs(loss.item() - float(jloss)) <= LOSS_RTOL[dtype] * float(jloss)
        names = [k for k, _ in model.named_parameters()]
        _assert_grads_close(dict(zip(names, (m.numpy() / 0.1 for m in opt_m))),
                            {k: v / 0.1 for k, v in _as_port(jm).items()}, dtype)
        got = {k: p.detach().numpy() for k, p in model.named_parameters()}
        want = _as_port(jp)
        atol = 1e-3 / 100 if dtype == "f32" else 2 * 1e-3
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0, err_msg=k)


def _sequences(seed=3, n=37, vocab=60):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, vocab, rng.integers(2, 30))] for _ in range(n)]


class TestTrainVsJax:
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_final_parameters(self, dtype):
        """37 sequences at batch 16: three steps an epoch, the last batch
        padded with 11 all-PAD rows; four epochs of the JAX data order."""
        jcfg, tcfg = _configs(dtype, vocab=60, max_len=16, d_model=16, n_heads=1)
        seqs, lr, epochs = _sequences(), 3e-3, 4
        want = _as_port(jseqrec.train(seqs, jcfg, epochs=epochs, batch_size=16, lr=lr, seed=5))
        run = seqrec.train(seqs, tcfg, epochs=epochs, batch_size=16, lr=lr, seed=5,
                           initial=seqrec.params_from_jax(
                               jseqrec.init_params(jax.random.PRNGKey(5), jcfg)),
                           device="cpu")
        steps = epochs * 3
        assert len(run.losses) == len(run.step_seconds) == steps
        assert all(np.isfinite(run.losses)) and run.losses[-1] < run.losses[0]
        assert set(run.params) == set(want)
        for k, w in want.items():
            got = run.params[k].numpy()
            assert got.dtype == np.float32
            if dtype == "f32":
                np.testing.assert_allclose(got, w, atol=lr / 100, rtol=0, err_msg=k)
            else:
                diff = np.abs(got - w)
                assert diff.max() <= lr * steps and np.median(diff) <= lr / 10, k

    def test_batch_larger_than_data_is_one_static_batch(self):
        _, tcfg = _configs("f32", vocab=60, max_len=16, d_model=16, n_heads=1)
        run = seqrec.train(_sequences(n=5), tcfg, epochs=3, batch_size=64, device="cpu")
        assert len(run.losses) == 3

    def test_train_defaults_to_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        _, tcfg = _configs("f32")
        with pytest.raises(RuntimeError, match="CUDA"):
            seqrec.train(_sequences(), tcfg, epochs=1)


class TestCheckpointResume:
    """The port's twin of tests/test_sessionrec_template.py's resume test."""

    def test_resume_equals_straight_run(self, tmp_path, caplog):
        seqs = [[(s + t) % 9 + 1 for t in range(8)] for s in range(40)]
        cfg = seqrec.SeqRecConfig(vocab=10, max_len=8, d_model=16, n_heads=1, n_layers=1)
        kw = dict(batch_size=8, seed=4, device="cpu")
        full = seqrec.train(seqs, cfg, epochs=6, **kw)
        d = str(tmp_path / "ckpt")
        seqrec.train(seqs, cfg, epochs=3, checkpoint_dir=d, checkpoint_every=1, **kw)
        resumed = seqrec.train(seqs, cfg, epochs=6, checkpoint_dir=d, checkpoint_every=1, **kw)
        assert len(resumed.losses) == 3 * 5      # only epochs 4-6 ran
        assert resumed.losses == full.losses[-15:]
        for k in full.params:
            torch.testing.assert_close(resumed.params[k], full.params[k], atol=1e-6, rtol=0)

        # a finished checkpoint returns its weights with no further steps
        again = seqrec.train(seqs, cfg, epochs=6, checkpoint_dir=d, checkpoint_every=1, **kw)
        assert again.losses == []
        assert all(torch.equal(again.params[k], resumed.params[k]) for k in full.params)

        # a mismatched config starts fresh, with a warning
        other = dataclasses.replace(cfg, d_model=32)
        with caplog.at_level(logging.WARNING, logger=seqrec.__name__):
            fresh = seqrec.train(seqs, other, epochs=1, checkpoint_dir=d, checkpoint_every=0,
                                 **kw)
        assert "different run" in caplog.text
        assert len(fresh.losses) == 5 and fresh.params["item_emb"].shape == (10, 32)


class TestRemat:
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("max_len", [32, 4096], ids=["full", "blockwise"])
    def test_remat_changes_no_value(self, dtype, max_len):
        """Recomputing each block in the backward pass gives the same loss
        and the same gradients on both attention routes: equal to a few
        f32 rounding steps (rtol 1e-6, atol 1e-8), since a recomputed
        tensor may reach a matmul in another memory layout."""
        jcfg, tcfg = _configs(dtype, max_len=max_len, n_layers=2,
                              **({"vocab": 50, "d_model": 32} if max_len == 4096 else {}))
        jparams = jseqrec.init_params(jax.random.PRNGKey(6), jcfg)
        seqs, tgts = _batch(tcfg, 6, batch=2 if max_len == 4096 else 4)
        base = _loss_and_grads(_port_model(tcfg, jparams), seqs, tgts)
        remat = _loss_and_grads(_port_model(dataclasses.replace(tcfg, remat=True), jparams),
                                seqs, tgts)
        assert remat[0] == base[0]
        for k in base[1]:
            np.testing.assert_allclose(remat[1][k], base[1][k], rtol=1e-6, atol=1e-8,
                                       err_msg=k)
