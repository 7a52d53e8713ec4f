"""The MoE sessionrec model (``models/moe_seqrec.py``) on the CPU at a
small size, against its plain float32 reference
(``models/moe_seqrec_reference.py``) on seeded weights, and its path
through the sessionrec template.

The size: hidden 64, 4 query heads over 2 KV heads of 16, layers
[sliding, sliding, sliding, full] with a window of 8 keys under
histories of up to 40, 8 experts top-2 of width 32, vocab 101.

Tolerances, each with its reason:

- f32 model against the f32 reference: ``F32_ATOL`` 2e-5 on logits of
  magnitude ~3 (the same f32 arithmetic in other summation orders: the
  batched products, the grouped experts, the f32 combine). The model in
  bf16 (its weights rounded to bf16, the reference given the same
  values) misses it by more than 100×, which a test pins.
- bf16 model against the reference: ``BF16_REL`` 0.08 on the median
  over the histories of ``||logits - reference|| / ||reference||``. A
  token whose top-2 experts change under bf16 rounding moves by a whole
  expert's output, so one history's error is heavy-tailed (0.006-0.34
  over eight seeds, most near 0.01): the median over histories reads the
  rounding, not the rare flip. The model reads 0.016 on these weights;
  the reference with every product operand rounded to fp8 e4m3 (the
  precision below bf16) reads 0.37 and misses it, which a test pins.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.models import moe_seqrec, moe_seqrec_reference, seqrec
from predictionio_tpu_torch.ops import flash_attention as flash_ops
from predictionio_tpu_torch.ops import moe, rope

F32_ATOL = 2e-5
BF16_REL = 0.08
V, S = 101, 48

YARN = {"rope_type": "yarn", "rope_theta": 500000, "factor": 16,
        "original_max_position_embeddings": 64, "beta_fast": 32, "beta_slow": 1,
        "attention_factor": 1.2772588722239782}
PLAIN = {"rope_type": "default", "rope_theta": 500000}


def _config(dtype="float32", **over) -> moe_seqrec.MoESeqRecConfig:
    obj = dict(vocab_size=V, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
               head_dim=16, layer_types=["sliding_attention"] * 3 + ["full_attention"],
               mlp_layer_types=["sparse"] * 4, sliding_window=8,
               rope_parameters={"full_attention": YARN, "sliding_attention": PLAIN},
               num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
               norm_topk_prob=True, rms_norm_eps=1e-6, num_hidden_layers=4, max_len=S,
               dtype=dtype)
    obj.update(over)
    return moe_seqrec.MoESeqRecConfig.from_json(obj)


def _params(cfg, seed=1):
    params = moe_seqrec.init_params(cfg, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 100)
    for name in params:
        if name.endswith("norm"):           # gains other than 1, so they are tested
            params[name] = (1 + 0.1 * torch.randn(params[name].shape, generator=gen)
                            ).to(cfg.dtype)
    return params


HISTORIES = [list(np.random.default_rng(7).integers(1, V, n)) for n in (40, 17, 9, 3, 1)]


def _batch(histories, width=S):
    seqs = torch.zeros((len(histories), width), dtype=torch.int64)
    for i, h in enumerate(histories):
        seqs[i, : len(h)] = torch.as_tensor(h)
    return seqs


def _model_logits(cfg, params, histories, **kw):
    model = moe_seqrec.MoESeqRec.from_state(cfg, params, "cpu")
    with torch.inference_mode():
        h = model(_batch(histories), **kw)
        return [model.logits(h[i, len(x) - 1]).float() for i, x in enumerate(histories)]


def _reference(cfg, params, histories, rounding=lambda x: x):
    return [moe_seqrec_reference.last_logits(params, cfg.to_json(), h, rounding)
            for h in histories]


def _median_rel(got, want) -> float:
    return float(torch.stack([(g - w).norm() / w.norm() for g, w in zip(got, want)]).median())


class TestAgainstReference:
    def test_f32_logits_at_the_last_real_position(self):
        cfg = _config()
        params = _params(cfg)
        got = _model_logits(cfg, params, HISTORIES)
        want = _reference(cfg, params, HISTORIES)
        for g, w in zip(got, want):
            assert w.abs().max() > 1.0
            torch.testing.assert_close(g, w, atol=F32_ATOL, rtol=0)

    def test_bf16_misses_the_f32_tolerance(self):
        cfg = _config("bfloat16")
        params = _params(cfg)
        got = _model_logits(cfg, params, HISTORIES)
        want = _reference(cfg, {k: v.float() for k, v in params.items()}, HISTORIES)
        worst = max(float((g - w).abs().max()) for g, w in zip(got, want))
        assert worst > 100 * F32_ATOL

    def test_bf16_logits_within_their_tolerance(self):
        cfg = _config("bfloat16")
        params = _params(cfg)
        got = _model_logits(cfg, params, HISTORIES)
        want = _reference(cfg, {k: v.float() for k, v in params.items()}, HISTORIES)
        assert _median_rel(got, want) <= BF16_REL

    def test_fp8_operands_miss_the_bf16_tolerance(self):
        def fp8(x):
            scale = x.abs().amax().clamp_min(1e-30) / 448.0
            return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

        cfg = _config("bfloat16")
        params = {k: v.float() for k, v in _params(cfg).items()}
        exact = _reference(cfg, params, HISTORIES)
        low = _reference(cfg, params, HISTORIES, fp8)
        assert _median_rel(low, exact) > BF16_REL

    @pytest.mark.parametrize("real_tokens", [None, 70, 500])
    def test_capacity_at_or_above_the_real_count_changes_nothing(self, real_tokens):
        cfg = _config()
        params = _params(cfg)
        got = _model_logits(cfg, params, HISTORIES, real_tokens=real_tokens)
        want = _model_logits(cfg, params, HISTORIES)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-6, rtol=0)


class TestAttention:
    @staticmethod
    def _naive(q, k, v, mask, window):
        B, H, L, D = q.shape
        group = H // k.shape[1]
        out = torch.zeros_like(q)
        for b in range(B):
            for h in range(H):
                for i in range(L):
                    keys = [j for j in range(i + 1) if mask[b, j] > 0
                            and (window is None or j > i - window)]
                    if not keys:
                        continue
                    kk, vv = k[b, h // group, keys], v[b, h // group, keys]
                    p = torch.softmax(kk @ q[b, h, i] / D ** 0.5, dim=0)
                    out[b, h, i] = p @ vv
        return out

    @pytest.mark.parametrize("window", [None, 1, 8, 100])
    @pytest.mark.parametrize("heads,kv_heads", [(4, 2), (4, 4), (6, 1)])
    def test_reference_gqa_window_against_naive_softmax(self, window, heads, kv_heads):
        gen = torch.Generator().manual_seed(heads * 10 + (window or 0))
        q = torch.randn((2, heads, 40, 16), generator=gen, dtype=torch.float64)
        k, v = (torch.randn((2, kv_heads, 40, 16), generator=gen, dtype=torch.float64)
                for _ in range(2))
        mask = torch.ones((2, 40))
        mask[1, 25:] = 0
        got = flash_ops.flash_attention_reference(q.float(), k.float(), v.float(),
                                                  causal=True, kv_mask=mask, window=window)
        want = self._naive(q, k, v, mask, window)
        torch.testing.assert_close(got.double(), want, atol=2e-6, rtol=0)

    @pytest.mark.parametrize("bad", ["non_causal_window", "zero_window", "kv_heads"])
    def test_refuses_what_it_does_not_take(self, bad):
        q = torch.randn((1, 4, 8, 16))
        k = torch.randn((1, 2 if bad != "kv_heads" else 3, 8, 16))
        kw = {"non_causal_window": dict(causal=False, window=4),
              "zero_window": dict(window=0), "kv_heads": {}}[bad]
        with pytest.raises(ValueError):
            flash_ops.flash_attention(q, k, k, **kw)

    def test_launch_flops_count_window_pairs(self):
        q = torch.zeros((1, 2, 10, 16))
        mask = torch.ones((1, 10))
        pairs = sum(min(i + 1, 3) for i in range(10))
        assert flash_ops.launch_flops(q, mask, True, 3) == 4 * 16 * 2 * pairs
        assert flash_ops.launch_flops(q, mask, True) == 4 * 16 * 2 * 55


class TestRope:
    @pytest.mark.parametrize("params", [PLAIN, YARN, dict(YARN, attention_factor=None)],
                             ids=["plain", "yarn", "yarn_inferred_factor"])
    def test_tables_match_transformers(self, params):
        mru = pytest.importorskip("transformers.modeling_rope_utils")
        from types import SimpleNamespace

        scaling = {k: v for k, v in params.items() if k not in ("rope_theta",)}
        conf = SimpleNamespace(rope_theta=params["rope_theta"], head_dim=128, hidden_size=2304,
                               num_attention_heads=32, max_position_embeddings=131072,
                               rope_scaling=scaling, partial_rotary_factor=1.0)
        fn = (mru._compute_yarn_parameters if params["rope_type"] == "yarn"
              else mru._compute_default_rope_parameters)
        inv_want, scale_want = fn(conf, "cpu")
        inv_got, scale_got = rope.inverse_frequencies(params, 128)
        torch.testing.assert_close(inv_got, inv_want, atol=0, rtol=0)
        assert scale_got == pytest.approx(scale_want, abs=0, rel=1e-12)
        cos, sin = rope.table(params, 128, 8192)
        pos = torch.arange(8192, dtype=torch.float32)
        freqs = (inv_want[:, None].float() @ pos[None, :]).T
        emb = torch.cat((freqs, freqs), dim=-1)
        torch.testing.assert_close(cos, emb.cos() * scale_want, atol=0, rtol=0)
        torch.testing.assert_close(sin, emb.sin() * scale_want, atol=0, rtol=0)

    def test_apply_is_rotate_half(self):
        x = torch.randn((1, 3, 2, 4))
        cos, sin = rope.table(PLAIN, 4, 3)
        got = rope.apply(x, cos, sin)
        x1, x2 = x[..., :2], x[..., 2:]
        c, s = cos[:, None, :2], sin[:, None, :2]
        torch.testing.assert_close(got, torch.cat((x1 * c - x2 * s, x2 * c + x1 * s), -1))


class TestRouting:
    def test_top_k_and_renormalisation(self):
        gen = torch.Generator().manual_seed(3)
        x, w = torch.randn((50, 16), generator=gen), torch.randn((16, 8), generator=gen)
        weights, experts = moe.route(x, w, 3, True)
        probs = torch.softmax(x @ w, -1)
        want_w, want_e = probs.topk(3, -1)
        assert torch.equal(experts, want_e)
        torch.testing.assert_close(weights, want_w / want_w.sum(-1, keepdim=True))
        torch.testing.assert_close(weights.sum(-1), torch.ones(50))
        raw, _ = moe.route(x, w, 3, False)
        torch.testing.assert_close(raw, want_w)

    def test_dispatch_sorts_real_pairs_by_expert_with_device_offsets(self):
        experts = torch.tensor([[2, 0], [1, 2], [0, 1], [2, 1]])
        valid = torch.tensor([True, False, True, True])
        order, counts, offsets = moe.dispatch(experts, valid, 3, capacity=6)
        assert counts.tolist() == [2, 2, 2] and offsets.tolist() == [2, 4, 6]
        assert offsets.dtype == torch.int32
        routed = experts.reshape(-1)[order].tolist()
        assert routed == [0, 0, 1, 1, 2, 2]
        assert all(valid[p // 2] for p in order.tolist())

    def test_padded_positions_are_not_dispatched_and_answers_unchanged(self):
        cfg = _config()
        params = _params(cfg)
        model = moe_seqrec.MoESeqRec.from_state(cfg, params, "cpu")
        histories = HISTORIES[1:3]
        with torch.inference_mode():
            h_pad = model(_batch(histories))
            routed = model.routed.sum(1).tolist()
            undispatched = int(model.undispatched)
            h_own = [model(_batch([x], len(x)))[0, -1] for x in histories]
        real = sum(map(len, histories))
        assert routed == [real * 2] * 4
        assert undispatched == (2 * S - real) * 4
        for i, x in enumerate(histories):
            torch.testing.assert_close(h_pad[i, len(x) - 1], h_own[i], atol=1e-6, rtol=0)


def _engine_model(cfg, params):
    from predictionio_tpu_torch.templates import sessionrec

    items = [f"i{n}" for n in range(1, V)]
    users = {f"u{n}": [f"i{int(x)}" for x in h] for n, h in enumerate(HISTORIES)}
    return sessionrec.init_engine_model(cfg, items, users, params=params, device="cpu")


class TestTemplate:
    def test_batch_predict_answers_the_reference_top_items(self):
        from predictionio_tpu_torch.templates import sessionrec

        cfg = _config()
        params = _params(cfg)
        model = _engine_model(cfg, params)
        algo = sessionrec.SeqRecAlgorithm(sessionrec.AlgorithmParams())
        queries = [(n, sessionrec.Query(user=f"u{n}", num=5)) for n in range(len(HISTORIES))]
        answers = dict(algo.batch_predict(model, queries))
        for n, h in enumerate(HISTORIES):
            ref = _reference(cfg, params, [h])[0]
            ref[0] = float("-inf")
            ref[torch.as_tensor(h)] = float("-inf")
            want = ref.topk(5).indices.tolist()
            got = [model.item_index[s.item] for s in answers[n].item_scores]
            assert got == want

    def test_save_load_round_trip_serves_the_same(self, tmp_path):
        from predictionio_tpu_torch.templates import sessionrec

        cfg = _config("bfloat16")
        model = _engine_model(cfg, _params(cfg))
        sessionrec.save_engine_model(model, str(tmp_path))
        doc = json.loads((tmp_path / "model.json").read_text())
        assert doc["kind"] == "moe_seqrec"
        loaded = sessionrec.load_engine_model(str(tmp_path), "cpu")
        assert loaded.cfg == cfg
        assert all(loaded.params[k].dtype == torch.bfloat16 and
                   torch.equal(loaded.params[k], v) for k, v in model.params.items())
        assert isinstance(loaded.as_module(), moe_seqrec.MoESeqRec)
        algo = sessionrec.SeqRecAlgorithm(sessionrec.AlgorithmParams())
        queries = [(0, sessionrec.Query(user="u0", num=5)), (1, sessionrec.Query(user="u2"))]
        assert algo.batch_predict(model, queries) == algo.batch_predict(loaded, queries)

    def test_a_model_saved_without_a_kind_loads_as_sasrec(self, tmp_path):
        from predictionio_tpu_torch.templates import sessionrec

        scfg = seqrec.SeqRecConfig(vocab=V, max_len=16, d_model=32, n_heads=2, n_layers=1)
        model = sessionrec.init_engine_model(scfg, [f"i{n}" for n in range(1, V)],
                                             {"u": ["i3", "i4"]}, device="cpu")
        sessionrec.save_engine_model(model, str(tmp_path))
        doc = json.loads((tmp_path / "model.json").read_text())
        del doc["kind"]
        (tmp_path / "model.json").write_text(json.dumps(doc))
        loaded = sessionrec.load_engine_model(str(tmp_path), "cpu")
        assert loaded.cfg == scfg and isinstance(loaded.as_module(), seqrec.SeqRec)
        assert all(v.dtype == torch.float32 for v in loaded.params.values())

    def test_sasrec_ignores_real_tokens(self):
        scfg = seqrec.SeqRecConfig(vocab=V, max_len=16, d_model=32, n_heads=2, n_layers=1)
        module = seqrec.SeqRec.from_state(scfg, seqrec.init_params(
            scfg, torch.Generator().manual_seed(0)), "cpu")
        hist = _batch([[3, 4, 5], [7]], 16)
        masks = torch.zeros((2, V))
        a = seqrec.predict_topk_batch(module, hist, 5, masks)
        b = seqrec.predict_topk_batch(module, hist, 5, masks, real_tokens=4)
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    def test_config_from_the_published_file_keeps_its_widths(self):
        from pathlib import Path

        path = Path(__file__).resolve().parent.parent / "benchmark" / "configs" / \
            "sessionrec-mellum2-s8192.json"
        cfg = moe_seqrec.MoESeqRecConfig.from_json(json.loads(path.read_text()))
        assert (cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads,
                cfg.head_dim) == (2304, 32, 4, 128)
        assert (cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_intermediate_size) == \
            (64, 8, 896)
        assert cfg.layers == (("sliding_attention",) * 3 + ("full_attention",)) * 7
        assert sum(np.prod(s) for _, s in moe_seqrec.weight_shapes(cfg)) == 12_149_915_904


class TestCollector:
    def test_counters_and_launch_kinds_on_scrape(self):
        from predictionio_tpu_torch.obs.device import flash_launch_collector

        cfg = _config()
        model = moe_seqrec.MoESeqRec.from_state(cfg, _params(cfg), "cpu")
        flash_ops.LAUNCHES_BY_KIND["window"] += 1      # as one launch on the card would

        def scrape():
            return {m.name: m for m in model.metric_families() + list(flash_launch_collector()())}

        before = scrape()
        with torch.inference_mode():
            model(_batch(HISTORIES[:2]))
        after = scrape()

        def total(fams, name):
            return sum(v for _, v in fams[name].samples) if name in fams else 0.0

        real = len(HISTORIES[0]) + len(HISTORIES[1])
        assert total(after, "pio_moe_routed_pairs_total") - \
            total(before, "pio_moe_routed_pairs_total") == real * 2 * 4
        assert total(after, "pio_moe_undispatched_positions_total") - \
            total(before, "pio_moe_undispatched_positions_total") == (2 * S - real) * 4
        assert {s[0]["kind"] for s in after["pio_flash_launches_total"].samples} == \
            {"full", "window"}

    def test_the_engine_model_exports_its_modules_counters(self):
        from predictionio_tpu_torch.templates import sessionrec

        cfg = _config()
        model = _engine_model(cfg, _params(cfg))
        assert model.metric_families() == []          # no module before the first predict
        algo = sessionrec.SeqRecAlgorithm(sessionrec.AlgorithmParams())
        algo.batch_predict(model, [(0, sessionrec.Query(user="u0", num=3))])
        fams = {m.name: m for m in model.metric_families()}
        assert sum(v for _, v in fams["pio_moe_routed_pairs_total"].samples) == \
            len(HISTORIES[0]) * 2 * 4

    def test_the_engine_server_collects_what_its_models_export(self):
        from types import SimpleNamespace

        from predictionio_tpu_torch.api.engine_server import EngineService
        from predictionio_tpu_torch.obs.registry import Metric

        fam = Metric(name="pio_moe_undispatched_positions_total", kind="counter", help="h",
                     samples=[({}, 3.0)])
        models = [SimpleNamespace(metric_families=lambda: [fam]), SimpleNamespace()]
        service = SimpleNamespace(deployed=SimpleNamespace(models=models))
        assert EngineService._model_metrics_collector(service) == [fam]
