"""The port's differentiable attention (``ops/attention.py``) held against
the JAX package's on the CPU, values and gradients, and the forward-only
guard of ``ops/flash_attention.py``.

Inputs are made with numpy from a seed and fed to both packages. The
masks carry right padding, left padding (causal rows that see no key)
and a fully-masked row, where ``blockwise_attention`` gives zero and
``full_attention`` the uniform average of V in both packages.

Tolerances: f32, atol 1e-5 / rtol 1e-5 on values and 1e-5 / 1e-4 on
gradients (the same f32 sums in another order); bf16, atol 1e-2 on
values and gradients (one bf16 rounding step of outputs of size ~1).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops.attention import blockwise_attention as jax_blockwise
from predictionio_tpu.ops.attention import full_attention as jax_full
from predictionio_tpu_torch.models import seqrec
from predictionio_tpu_torch.ops import flash_attention as flash_ops
from predictionio_tpu_torch.ops.attention import blockwise_attention, full_attention

B, H, S, D = 3, 2, 48, 16
TOL = {np.float32: dict(value=(1e-5, 1e-5), grad=(1e-5, 1e-4)),
       "bfloat16": dict(value=(1e-2, 0.0), grad=(1e-2, 0.0))}


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(4))
    mask = np.ones((B, S), dtype=np.float32)
    mask[0, 30:] = 0.0          # right padding
    mask[1, :9] = 0.0           # left padding: the first causal rows see no key
    mask[2] = 0.0               # an all-PAD row: every query fully masked
    return q, k, v, w, mask


def _jax_value_and_grads(fn, q, k, v, w, mask, dtype, **kw):
    """fn's output and the gradients of sum(out * w) by q, k and v."""
    def loss(q, k, v):
        out = fn(q, k, v, kv_mask=jnp.asarray(mask), **kw)
        return jnp.sum(out.astype(jnp.float32) * w), out

    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(*args)
    return np.asarray(out.astype(jnp.float32)), [np.asarray(g.astype(jnp.float32))
                                                 for g in grads]


def _torch_value_and_grads(fn, q, k, v, w, mask, dtype, **kw):
    args = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = fn(*args, kv_mask=torch.from_numpy(mask), **kw)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return out.detach().float().numpy(), [a.grad.float().numpy() for a in args]


DTYPES = [(jnp.float32, torch.float32, np.float32), (jnp.bfloat16, torch.bfloat16, "bfloat16")]


class TestBlockwiseVsJax:
    @pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
    @pytest.mark.parametrize("causal", [True, False], ids=["causal", "non_causal"])
    @pytest.mark.parametrize("q_block", [16, None], ids=["explicit_q_block", "auto_q_block"])
    def test_values_and_gradients(self, dtypes, causal, q_block):
        jdt, tdt, key = dtypes
        q, k, v, w, mask = _inputs(0)
        want, want_g = _jax_value_and_grads(jax_blockwise, q, k, v, w, mask, jdt,
                                            causal=causal, q_block=q_block)
        got, got_g = _torch_value_and_grads(blockwise_attention, q, k, v, w, mask, tdt,
                                            causal=causal, q_block=q_block)
        atol, rtol = TOL[key]["value"]
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
        assert np.all(got[2] == 0.0)            # the all-PAD row gives zero
        if causal:
            assert np.all(got[1, :, :9] == 0.0)  # causal rows with no key give zero
        atol, rtol = TOL[key]["grad"]
        for g, wg in zip(got_g, want_g):
            np.testing.assert_allclose(g, wg, atol=atol, rtol=rtol)

    def test_auto_q_block_and_one_tile_fallback(self):
        # 48 → 16 (largest of 128..8 dividing it); 20 divides by none → one tile
        rng = np.random.default_rng(1)
        for s in (48, 20):
            q, k, v = (rng.standard_normal((1, 2, s, 8)).astype(np.float32) for _ in range(3))
            want = np.asarray(jax_blockwise(*map(jnp.asarray, (q, k, v))))
            got = blockwise_attention(*map(torch.from_numpy, (q, k, v)))
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)

    def test_q_block_must_divide(self):
        q = torch.zeros((1, 1, S, D))
        with pytest.raises(ValueError, match="divide"):
            blockwise_attention(q, q, q, q_block=20)
        with pytest.raises(ValueError, match="divide"):
            jax_blockwise(*(jnp.zeros((1, 1, S, D)),) * 3, q_block=20)

    def test_matches_full_attention_where_a_key_is_valid(self):
        q, k, v, _, mask = _inputs(2)
        t = [torch.from_numpy(x) for x in (q, k, v)]
        m = torch.from_numpy(mask)
        block = blockwise_attention(*t, kv_mask=m, q_block=8)
        full = full_attention(*t, kv_mask=m)
        torch.testing.assert_close(block[0], full[0], atol=1e-5, rtol=1e-5)
        # the fully-masked row: zero against full attention's uniform average
        assert torch.all(block[2] == 0.0)
        torch.testing.assert_close(full[2], t[2][2].mean(dim=-2, keepdim=True).expand_as(full[2]),
                                   atol=1e-5, rtol=1e-5)


class TestFullAttentionGradientsVsJax:
    @pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
    @pytest.mark.parametrize("causal", [True, False], ids=["causal", "non_causal"])
    def test_values_and_gradients(self, dtypes, causal):
        jdt, tdt, key = dtypes
        q, k, v, w, mask = _inputs(3)
        want, want_g = _jax_value_and_grads(jax_full, q, k, v, w, mask, jdt, causal=causal)
        got, got_g = _torch_value_and_grads(full_attention, q, k, v, w, mask, tdt,
                                            causal=causal)
        atol, rtol = TOL[key]["value"]
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
        atol, rtol = TOL[key]["grad"]
        for g, wg in zip(got_g, want_g):
            np.testing.assert_allclose(g, wg, atol=atol, rtol=rtol)


class TestFlashIsForwardOnly:
    """The kernel writes into a fresh tensor with no grad_fn, so the
    wrapper refuses to run where a gradient is being recorded."""

    def test_guard_fires_with_grad(self):
        q, k, v = (torch.randn((1, 2, 16, 16), generator=torch.Generator().manual_seed(i))
                   for i in range(3))
        with pytest.raises(RuntimeError, match="forward-only"):
            flash_ops.flash_attention(q.requires_grad_(), k, v)
        with torch.no_grad():
            flash_ops.flash_attention(q, k, v)
        with torch.inference_mode():
            flash_ops.flash_attention(q.detach(), k, v)

    def test_training_forward_never_reaches_flash(self, monkeypatch):
        calls = []
        monkeypatch.setattr(seqrec, "flash_attention",
                            lambda *a, **kw: calls.append(1) or flash_ops.flash_attention(*a, **kw))
        cfg = seqrec.SeqRecConfig(vocab=20, max_len=8, d_model=32, n_heads=2, n_layers=1,
                                  dtype=torch.float32)
        model = seqrec.SeqRec(cfg, "cpu").requires_grad_()
        model.load_state_dict(seqrec.init_params(cfg, torch.Generator().manual_seed(0)))
        seqs = torch.randint(1, 20, (2, 8), generator=torch.Generator().manual_seed(1))
        seqrec.next_item_loss(model, seqs, seqs).backward()
        assert calls == [] and model.item_emb.grad is not None
        # the serving forward does reach it, and with grad it refuses
        with pytest.raises(RuntimeError, match="forward-only"):
            model(seqs)
        assert calls == [1]
