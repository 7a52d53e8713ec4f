"""The flash-attention CUDA kernel against its plain version, on the card.

Needs an NVIDIA card (sm_90a) and nvcc; every test skips without them.
Imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_flash_attention_cuda.py --noconftest
"""

from __future__ import annotations

import pytest
import torch

from predictionio_tpu_torch.ops import flash_attention as flash_ops

pytestmark = pytest.mark.cuda

#: both compute in f32: f32 differs by summation order, bf16 by a
#: rounding step of the output
TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5), torch.bfloat16: dict(atol=1e-2, rtol=8e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [64, 200])
def test_kernel_matches_plain(cuda, dtype, d, causal, s):
    gen = torch.Generator(device=cuda).manual_seed(d + s)
    q, k, v = (torch.randn((2, 3, s, d), generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    mask = torch.ones((2, s), device=cuda)
    mask[0, s // 2:] = 0.0
    mask[1, : s // 5] = 0.0
    before = flash_ops.LAUNCHES
    got = flash_ops.flash_attention(q, k, v, causal=causal, kv_mask=mask)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES == before + 1
    want = flash_ops.flash_attention_reference(q, k, v, causal=causal, kv_mask=mask)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_fully_masked_batch_row_is_zero(cuda):
    q = torch.randn((2, 1, 100, 64), device=cuda)
    mask = torch.ones((2, 100), device=cuda)
    mask[1] = 0.0
    out = flash_ops.flash_attention(q, q, q, causal=False, kv_mask=mask)
    assert torch.all(out[1] == 0)
    assert torch.all(out[0].abs().sum(-1) > 0)
