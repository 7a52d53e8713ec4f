"""The MoE sessionrec model's card routes: the flash kernel's GQA and
sliding-window paths against the plain version, the grouped expert
products against a loop over experts, and the model against its plain
reference, on the card.

Needs an NVIDIA card (sm_90a) and nvcc; every test skips without them.
Imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_moe_seqrec_cuda.py --noconftest
"""

from __future__ import annotations

import pytest
import torch

from predictionio_tpu_torch.models import moe_seqrec, moe_seqrec_reference
from predictionio_tpu_torch.ops import flash_attention as flash_ops
from predictionio_tpu_torch.ops import moe

pytestmark = pytest.mark.cuda

#: as tests/test_torch_flash_attention_cuda.py: f32 differs by summation
#: order; bf16 by the output's rounding and P's rounding before PV
TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5), torch.bfloat16: dict(atol=1e-2, rtol=8e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (8, 2), (32, 4)])
@pytest.mark.parametrize("window", [None, 1, 64, 100, 1024])
def test_kernel_gqa_window_matches_plain(cuda, dtype, d, heads, kv_heads, window):
    s = 333
    gen = torch.Generator(device=cuda).manual_seed(d + heads + (window or 0))
    q = torch.randn((2, heads, s, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((2, kv_heads, s, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    mask = torch.ones((2, s), device=cuda)
    mask[0, 250:] = 0.0
    kind = "full" if window is None else "window"
    before = flash_ops.LAUNCHES_BY_KIND[kind]
    got = flash_ops.flash_attention(q, k, v, causal=True, kv_mask=mask, window=window)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES_BY_KIND[kind] == before + 1
    want = flash_ops.flash_attention_reference(q, k, v, causal=True, kv_mask=mask,
                                               window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 24, 50, 96])
def test_head_dim_outside_the_kernel_is_padded_to_it(cuda, dtype, d):
    # zero-padded to the next kernel head dim, scaled by 1/sqrt(d): one
    # counted launch, the plain version's answer
    gen = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn((2, 4, 130, d), generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    mask = torch.ones((2, 130), device=cuda)
    mask[1, 77:] = 0.0
    before = flash_ops.LAUNCHES
    got = flash_ops.flash_attention(q, k, v, causal=True, kv_mask=mask)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES == before + 1 and got.shape == q.shape
    want = flash_ops.flash_attention_reference(q, k, v, causal=True, kv_mask=mask)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_head_dim_above_the_kernels_raises_on_the_card(cuda):
    q = torch.zeros((1, 1, 16, 256), device=cuda)
    with pytest.raises(ValueError, match="head dim 256"):
        flash_ops.flash_attention(q, q, q)


def test_grouped_experts_match_a_loop_over_experts(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    N, d, E, k, f = 300, 256, 16, 4, 128
    x = torch.randn((N, d), generator=gen, device=cuda).bfloat16()
    w_r = (torch.randn((d, E), generator=gen, device=cuda) / d ** 0.5).bfloat16()
    w_gu = (torch.randn((E, d, 2 * f), generator=gen, device=cuda) / d ** 0.5).bfloat16()
    w_d = (torch.randn((E, f, d), generator=gen, device=cuda) / f ** 0.5).bfloat16()
    valid = torch.rand((N,), generator=gen, device=cuda) > 0.3
    weights, experts = moe.route(x, w_r, k, True)
    order, counts, offsets = moe.dispatch(experts, valid, E, capacity=int(valid.sum()) * k + 7)
    got = moe.experts(x, weights, order, offsets, w_gu, w_d).float()
    want = torch.zeros((N, d), device=cuda)
    for e in range(E):
        tok, slot = torch.nonzero((experts == e) & valid[:, None], as_tuple=True)
        h = x[tok].float() @ w_gu[e].float()
        a = (torch.nn.functional.silu(h[:, :f]) * h[:, f:]).bfloat16().float()
        want.index_add_(0, tok, (a @ w_d[e].float()) * weights[tok, slot, None].float())
    assert torch.all(got[~valid] == 0)
    # bf16 products and the bf16 rounding of each pair's output
    torch.testing.assert_close(got, want, atol=3e-2, rtol=2e-2)


def test_model_matches_reference_on_the_card(cuda):
    cfg = moe_seqrec.MoESeqRecConfig.from_json(dict(
        vocab_size=501, hidden_size=256, num_attention_heads=8, num_key_value_heads=2,
        head_dim=128, layer_types=["sliding_attention"] * 3 + ["full_attention"],
        sliding_window=64, num_experts=16, num_experts_per_tok=4, moe_intermediate_size=128,
        rope_parameters={
            "full_attention": {"rope_type": "yarn", "rope_theta": 500000, "factor": 16,
                               "original_max_position_embeddings": 256, "beta_fast": 32,
                               "beta_slow": 1, "attention_factor": 1.2772588722239782},
            "sliding_attention": {"rope_type": "default", "rope_theta": 500000}},
        max_len=256, dtype="bfloat16"))
    params = {k: v.to(cuda) for k, v in moe_seqrec.init_params(
        cfg, torch.Generator().manual_seed(5)).items()}
    model = moe_seqrec.MoESeqRec.from_state(cfg, params, cuda)
    gen = torch.Generator().manual_seed(6)
    lengths = [256, 200, 65, 7]
    seqs = torch.zeros((4, 256), dtype=torch.int64)
    for i, L in enumerate(lengths):
        seqs[i, :L] = torch.randint(1, 501, (L,), generator=gen)
    with torch.inference_mode():
        h = model(seqs.to(cuda), real_tokens=sum(lengths))
        for i, L in enumerate(lengths):
            got = model.logits(h[i, L - 1])
            want = moe_seqrec_reference.last_logits(params, cfg.to_json(), seqs[i, :L].tolist())
            # bf16 weights, activations and logits against f32 throughout
            # (the same bf16 weight values): a few bf16 steps of the logits
            assert (got - want).abs().max().item() < 0.15 * want.abs().max().item()
