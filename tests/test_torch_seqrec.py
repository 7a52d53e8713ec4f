"""The port's SeqRec model held against the JAX package's on the CPU.

Weights are JAX's own draw, carried over through ``params_from_jax``;
sequences are made with numpy from a seed. On the CPU both attention
paths are plain code (JAX: full_attention, which ``forward(...,
inference=True)`` dispatches to off the TPU; port: the flash reference),
and they agree on every row these right-padded histories produce.

Tolerances: f32, atol 1e-4 on hidden states (two layers of f32 matmuls
in different summation orders); bf16, atol 0.0625 on hidden states (the
two frameworks round bf16 at the same ops, but a matmul or GELU may land
one bf16 step apart, 2**-6 at |x| in [2, 4), and a step carries through
the residual stream) and 0.05 on the f32 logits.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.models import seqrec as jseqrec
from predictionio_tpu.ops import topk as jtopk
from predictionio_tpu_torch.models import seqrec
from predictionio_tpu_torch.ops import topk

V, L, DM, NH, NL = 80, 24, 32, 2, 2


def _configs(jdtype, tdtype):
    jcfg = jseqrec.SeqRecConfig(vocab=V, max_len=L, d_model=DM, n_heads=NH,
                                n_layers=NL, dtype=jdtype)
    tcfg = seqrec.SeqRecConfig(vocab=V, max_len=L, d_model=DM, n_heads=NH,
                               n_layers=NL, dtype=tdtype)
    return jcfg, tcfg


def _weights(jcfg, seed=1):
    params = jseqrec.init_params(jax.random.PRNGKey(seed), jcfg)
    params = jax.tree.map(np.asarray, params)
    # non-trivial LayerNorm affines and biases, so their casts are tested
    rng = np.random.default_rng(seed)
    for layer in params["layers"]:
        for ln in ("ln1", "ln2"):
            layer[ln]["g"] = (1 + 0.1 * rng.standard_normal(DM)).astype(np.float32)
            layer[ln]["b"] = (0.1 * rng.standard_normal(DM)).astype(np.float32)
        layer["b1"] = (0.1 * rng.standard_normal(layer["b1"].shape)).astype(np.float32)
        layer["b2"] = (0.1 * rng.standard_normal(DM)).astype(np.float32)
    return params


def _histories(seed=2, batch=4):
    rng = np.random.default_rng(seed)
    seqs = rng.integers(1, V, (batch, L)).astype(np.int64)
    for i, n in enumerate((L, 17, 5, 1)[:batch]):
        seqs[i, n:] = 0                         # right padding, as batch_predict pads
    return seqs


def _vocab_masks(seqs):
    masks = np.zeros((len(seqs), V), np.float32)
    masks[:, 0] = -1e30
    for i, s in enumerate(seqs):
        masks[i, s[s > 0]] = -1e30
    return masks


def _port_model(params, tcfg):
    return seqrec.SeqRec.from_state(tcfg, seqrec.params_from_jax(params), "cpu")


class TestForwardVsJax:
    def test_f32_hidden_states(self):
        jcfg, tcfg = _configs(jnp.float32, torch.float32)
        params = _weights(jcfg)
        seqs = _histories()
        want = np.asarray(jseqrec.forward(params, jnp.asarray(seqs, jnp.int32), jcfg,
                                          inference=True))
        with torch.inference_mode():
            got = _port_model(params, tcfg)(torch.from_numpy(seqs)).numpy()
        assert got.shape == (4, L, DM) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)

    def test_bf16_hidden_states(self):
        jcfg, tcfg = _configs(jnp.bfloat16, torch.bfloat16)
        params = _weights(jcfg)
        seqs = _histories()
        want = np.asarray(jseqrec.forward(params, jnp.asarray(seqs, jnp.int32), jcfg,
                                          inference=True).astype(jnp.float32))
        with torch.inference_mode():
            got = _port_model(params, tcfg)(torch.from_numpy(seqs))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, atol=0.0625)

    def test_layer_norm_matches_jax(self):
        rng = np.random.default_rng(3)
        x = (3 * rng.standard_normal((5, DM)) + 1).astype(np.float32)
        g = rng.standard_normal(DM).astype(np.float32)
        b = rng.standard_normal(DM).astype(np.float32)
        ln = seqrec.LayerNorm(DM, torch.device("cpu"))
        ln.load_state_dict({"g": torch.from_numpy(g), "b": torch.from_numpy(b)})
        want = np.asarray(jseqrec._ln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
        np.testing.assert_allclose(ln(torch.from_numpy(x)).numpy(), want, atol=1e-5)


class TestPredictTopkVsJax:
    def test_f32_identical_topk(self):
        jcfg, tcfg = _configs(jnp.float32, torch.float32)
        params = _weights(jcfg)
        seqs = _histories()
        masks = _vocab_masks(seqs)
        js, ji = jseqrec.predict_topk_batch(params, jnp.asarray(seqs, jnp.int32), 10,
                                            jcfg, jnp.asarray(masks))
        ts, ti = seqrec.predict_topk_batch(_port_model(params, tcfg),
                                           torch.from_numpy(seqs), 10,
                                           torch.from_numpy(masks))
        js, ji = np.asarray(js), np.asarray(ji)
        np.testing.assert_allclose(ts.numpy(), js, atol=1e-4, rtol=1e-4)
        # identical ids wherever the scores are distinct
        gaps = np.diff(js, axis=1)
        distinct = np.ones_like(js, bool)
        distinct[:, 1:] &= np.abs(gaps) > 1e-4
        distinct[:, :-1] &= np.abs(gaps) > 1e-4
        np.testing.assert_array_equal(ti.numpy()[distinct], ji[distinct])
        assert not set(ti.numpy()[0]) & set(seqs[0][seqs[0] > 0])

    def test_bf16_topk_overlap(self):
        jcfg, tcfg = _configs(jnp.bfloat16, torch.bfloat16)
        params = _weights(jcfg)
        seqs = _histories()
        masks = _vocab_masks(seqs)
        js, ji = jseqrec.predict_topk_batch(params, jnp.asarray(seqs, jnp.int32), 10,
                                            jcfg, jnp.asarray(masks))
        ts, ti = seqrec.predict_topk_batch(_port_model(params, tcfg),
                                           torch.from_numpy(seqs), 10,
                                           torch.from_numpy(masks))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=0.05)
        for a, b in zip(ti.numpy(), np.asarray(ji)):
            assert len(set(a) & set(b)) >= 8

    def test_predict_topk_single_mask(self):
        jcfg, tcfg = _configs(jnp.float32, torch.float32)
        params = _weights(jcfg)
        seqs = _histories(batch=2)
        mask = np.zeros(V, np.float32)
        mask[0] = -1e30
        js, _ = jseqrec.predict_topk(params, jnp.asarray(seqs, jnp.int32), 5, jcfg,
                                     jnp.asarray(mask))
        ts, _ = seqrec.predict_topk(_port_model(params, tcfg), torch.from_numpy(seqs), 5,
                                    torch.from_numpy(mask))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4, rtol=1e-4)

    def test_logits_from_hidden(self):
        jcfg, tcfg = _configs(jnp.bfloat16, torch.bfloat16)
        params = _weights(jcfg)
        rng = np.random.default_rng(4)
        h = rng.standard_normal((2, 3, DM)).astype(np.float32)
        want = np.asarray(jseqrec.logits_from_hidden(
            params, jnp.asarray(h).astype(jnp.bfloat16)))
        got = seqrec.logits_from_hidden(_port_model(params, tcfg),
                                        torch.from_numpy(h).to(torch.bfloat16))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


class TestParams:
    def test_params_from_jax_fills_every_module_tensor(self):
        jcfg, tcfg = _configs(jnp.float32, torch.float32)
        state = seqrec.params_from_jax(_weights(jcfg))
        module = seqrec.SeqRec(tcfg, "cpu")
        assert set(state) == set(module.state_dict())
        for name, t in module.state_dict().items():
            assert state[name].shape == t.shape and state[name].dtype == torch.float32

    def test_init_params_shapes_scales_and_seed(self):
        _, tcfg = _configs(jnp.float32, torch.float32)
        a = seqrec.init_params(tcfg, torch.Generator().manual_seed(0))
        b = seqrec.init_params(tcfg, torch.Generator().manual_seed(0))
        from_jax = seqrec.params_from_jax(jseqrec.init_params(
            jax.random.PRNGKey(0), _configs(jnp.float32, torch.float32)[0]))
        assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in from_jax.items()}
        assert all(torch.equal(a[k], b[k]) for k in a)
        # the JAX draw: N(0, 1/fan_in) for dense weights and embeddings
        assert abs(a["item_emb"].std().item() - DM ** -0.5) < 0.02
        assert abs(a["layers.1.w2"].std().item() - (4 * DM) ** -0.5) < 0.01

    def test_config_json_round_trip_and_jax_fields(self):
        _, tcfg = _configs(jnp.float32, torch.bfloat16)
        assert seqrec.SeqRecConfig.from_json(tcfg.to_json()) == tcfg
        jcfg = dataclasses.replace(_configs(jnp.bfloat16, None)[0], remat=True, dropout=0.1)
        assert seqrec.SeqRecConfig.from_json(dataclasses.asdict(jcfg)) == \
            dataclasses.replace(tcfg, remat=True)

    def test_module_defaults_to_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        _, tcfg = _configs(jnp.float32, torch.float32)
        with pytest.raises(RuntimeError, match="CUDA"):
            seqrec.SeqRec(tcfg)


class TestHostHelpers:
    def test_pad_sequences_matches_jax(self):
        seqs = [[1, 2, 3], [4], list(range(1, 40)), []]
        for got, want in zip(seqrec.pad_sequences(seqs, 16),
                             jseqrec.pad_sequences(seqs, 16)):
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("k", [1, 5, 10, 11, 32, 33, 999, 1000, 1001, 5000])
    @pytest.mark.parametrize("n_max", [7, 100, 4096])
    def test_serving_k_matches_jax(self, k, n_max):
        assert topk.serving_k(k, n_max) == jtopk.serving_k(k, n_max)
